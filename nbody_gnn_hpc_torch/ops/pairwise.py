"""Direct O(N^2) softened-gravity accelerations: CUDA kernels + plain
versions.

Port of ``nbody_gnn_hpc_tpu/ops/pairwise.py``:

    a_i = sum_j G m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}

- :func:`accelerations_tiled` (kernel 3, ``pallas_accelerations``): one
  thread per receiver, sources staged in tiles; (N, 3) or (B, N, 3).
- :func:`accelerations_small` (kernel 4, ``pallas_accelerations_small``):
  N <= ``SMALL_MAX_N``, each system staged whole; an ensemble (B, N, 3) is
  one launch (what ``jax.vmap`` of the TPU kernel gave).
- :func:`accelerations_symmetric` (kernel 6,
  ``pallas_accelerations_symmetric``): every tile pair (I, J >= I) once,
  the reaction on the j side by Newton's third law; one system (N, 3).
- :func:`accelerations_symmetric_mxu` (kernel 5,
  ``pallas_accelerations_symmetric_mxu``): kernel 6's schedule with the
  mass weighting and the sums as tensor-core products (the moment
  decomposition).  Like its JAX counterpart it is dispatched by nothing:
  numerically unsound for close pairs, kept as a public function.

CUDA tensors go to the kernels in ``csrc/pairwise.cu`` (its source note
states the designs and the H100 bounds); each wrapper's ``launches`` counts
them.  CPU tensors go to the ``*_reference`` functions, the same arithmetic
step by step in torch ops.  Nothing falls back: on a CUDA tensor a wrapper
launches its kernel or raises.

A coincident pair (the self pair included) contributes exactly zero in all
forms: the factor is selected away where ``d2 == 0``.  The TPU kernels 4
and 6 instead multiply a finite ``s`` by a zero displacement (finite for
m <~ 5e21 at the default softening); the results are equal wherever those
are finite.  Sums are taken in a fixed order (no float atomics): reruns are
bit-identical.
"""

import ctypes

import torch

from nbody_gnn_hpc_torch.device import G, SOFTENING

TILE = 128          # receivers per block / sources per staged tile / kernel 6's tile
SMALL_MAX_N = 1024  # kernel 4 stages a whole system in shared memory


def _pair_planes(pos_i: torch.Tensor, pos_j: torch.Tensor, soft2: float):
    """(s, dx, dy, dz) planes (..., I, J): d*[i, j] = coord_j - coord_i and
    s = (d2 + eps^2)^(-3/2), zero where d2 == 0."""
    xi, yi, zi = pos_i.unbind(-1)
    xj, yj, zj = pos_j.unbind(-1)
    dx = xj.unsqueeze(-2) - xi.unsqueeze(-1)
    dy = yj.unsqueeze(-2) - yi.unsqueeze(-1)
    dz = zj.unsqueeze(-2) - zi.unsqueeze(-1)
    d2 = dx * dx + dy * dy + dz * dz
    inv_r = torch.rsqrt(d2 + soft2)
    s = inv_r * inv_r * inv_r
    return torch.where(d2 > 0, s, torch.zeros_like(s)), dx, dy, dz


def _row_sums(f, dx, dy, dz) -> torch.Tensor:
    return torch.stack([(f * dx).sum(-1), (f * dy).sum(-1),
                        (f * dz).sum(-1)], dim=-1)


def accelerations_small_reference(positions: torch.Tensor,
                                  masses: torch.Tensor,
                                  softening: float = SOFTENING
                                  ) -> torch.Tensor:
    """Plain version of kernel 4: the whole (N, N) pair plane at once.
    positions (..., N, 3), masses (..., N) -> (..., N, 3)."""
    s, dx, dy, dz = _pair_planes(positions, positions, softening ** 2)
    return _row_sums((G * masses).unsqueeze(-2) * s, dx, dy, dz)


def accelerations_tiled_reference(positions: torch.Tensor,
                                  masses: torch.Tensor,
                                  softening: float = SOFTENING,
                                  tile: int = TILE) -> torch.Tensor:
    """Plain version of kernel 3: all receivers against source tiles of
    ``tile`` particles, summed in ascending j.  positions (..., N, 3),
    masses (..., N) -> (..., N, 3)."""
    soft2 = softening ** 2
    gm = G * masses
    acc = torch.zeros_like(positions)
    for j0 in range(0, positions.shape[-2], tile):
        s, dx, dy, dz = _pair_planes(positions,
                                     positions[..., j0:j0 + tile, :], soft2)
        acc = acc + _row_sums(gm[..., None, j0:j0 + tile] * s, dx, dy, dz)
    return acc


def accelerations_symmetric_reference(positions: torch.Tensor,
                                      masses: torch.Tensor,
                                      softening: float = SOFTENING,
                                      tile: int = TILE) -> torch.Tensor:
    """Plain version of kernel 6 for one system (N, 3): each tile pair
    (I, J >= I) computed once; the i side takes the row sums weighted by
    G m_j, the j side the negated column sums weighted by G m_i; the
    diagonal tile is the full plane, i side only."""
    soft2 = softening ** 2
    gm = G * masses
    n = positions.shape[0]
    acc = torch.zeros_like(positions)
    for i0 in range(0, n, tile):
        rows = slice(i0, i0 + tile)
        for j0 in range(i0, n, tile):
            cols = slice(j0, j0 + tile)
            s, dx, dy, dz = _pair_planes(positions[rows], positions[cols],
                                         soft2)
            tx, ty, tz = s * dx, s * dy, s * dz
            gmj = gm[None, cols]
            acc[rows] += torch.stack([(gmj * tx).sum(1), (gmj * ty).sum(1),
                                      (gmj * tz).sum(1)], dim=-1)
            if j0 == i0:
                continue
            gmi = gm[rows, None]
            acc[cols] -= torch.stack([(gmi * tx).sum(0), (gmi * ty).sum(0),
                                      (gmi * tz).sum(0)], dim=-1)
    return acc


def accelerations_symmetric_mxu_reference(positions: torch.Tensor,
                                          masses: torch.Tensor,
                                          softening: float = SOFTENING,
                                          tile: int = TILE) -> torch.Tensor:
    """Plain version of kernel 5 for one system (N, 3): the moment
    decomposition of ``pallas_accelerations_symmetric_mxu``.  Positions are
    centred and W = G m [1, x, y, z] (the kernel pads W to 8 columns, the
    tensor-core instruction's width; zero columns change nothing here).  For
    each tile pair (I, J >= I), with s = (d2 + eps^2)^(-3/2) zeroed where
    d2 == 0, the i side takes M = s @ W_J, a_i += M[:, 1:4] - x_i M[:, 0],
    and the j side Mj = s^T @ W_I, a_j += Mj[:, 1:4] - x_j Mj[:, 0]; the
    diagonal tile is the full plane, i side only.  On CUDA tensors the
    products are float32 cuBLAS calls as long as
    ``torch.backends.cuda.matmul.allow_tf32`` stays False (the default)."""
    soft2 = softening ** 2
    pos = positions - positions.mean(0, keepdim=True)
    gm = (G * masses)[:, None]
    w = torch.cat([gm, gm * pos], dim=1)
    n = pos.shape[0]
    acc = torch.zeros_like(pos)
    for i0 in range(0, n, tile):
        rows = slice(i0, i0 + tile)
        for j0 in range(i0, n, tile):
            cols = slice(j0, j0 + tile)
            s = _pair_planes(pos[rows], pos[cols], soft2)[0]
            m = s @ w[cols]
            acc[rows] += m[:, 1:4] - pos[rows] * m[:, :1]
            if j0 == i0:
                continue
            mj = s.t() @ w[rows]
            acc[cols] += mj[:, 1:4] - pos[cols] * mj[:, :1]
    return acc


def _cuda_operands(name: str, positions: torch.Tensor, masses: torch.Tensor,
                   batched_ok: bool = True):
    """Check what the kernels take and return contiguous (B, N, 3) positions
    and (B, N) masses (masses (N,) are shared by the batch)."""
    if positions.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{positions.device}")
    if masses.device != positions.device:
        raise ValueError(f"masses are on {masses.device}, positions on "
                         f"{positions.device}")
    if positions.dtype != torch.float32 or masses.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 tensors, got "
                        f"{positions.dtype} and {masses.dtype}")
    dims = (2, 3) if batched_ok else (2,)
    if positions.dim() not in dims or positions.shape[-1] != 3:
        raise ValueError(f"{name} takes positions (N, 3)"
                         + (" or (B, N, 3)" if batched_ok else "")
                         + f", got {tuple(positions.shape)}")
    pos = positions if positions.dim() == 3 else positions.unsqueeze(0)
    b, n, _ = pos.shape
    if masses.shape not in ((n,), (b, n)) or masses.dim() >= positions.dim():
        raise ValueError(f"masses {tuple(masses.shape)} do not match "
                         f"positions {tuple(positions.shape)}")
    if b > 65535:
        raise ValueError(f"{name} takes at most 65535 systems, got {b}")
    return pos.contiguous(), masses.expand(b, n).contiguous()


def _launch_batched(symbol: str, wrapper, positions, masses, softening):
    """Launch kernel 3 or 4 (the same C signature) and count it."""
    from nbody_gnn_hpc_torch.ops.cuda_build import load_library

    pos, m = _cuda_operands(wrapper.__name__, positions, masses)
    b, n, _ = pos.shape
    fn = getattr(load_library("pairwise"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    acc = torch.empty_like(pos)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        rc = fn(pos.data_ptr(), m.data_ptr(), acc.data_ptr(), b, n,
                float(softening) ** 2, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return acc.view(positions.shape)


def accelerations_tiled(positions: torch.Tensor, masses: torch.Tensor,
                        softening: float = SOFTENING) -> torch.Tensor:
    """Tiled all-pairs accelerations (kernel 3; JAX counterpart
    ``pallas_accelerations``).  positions (N, 3) or (B, N, 3) float32,
    masses (N,) or (B, N) -> accelerations shaped as positions.  CUDA
    tensors launch the kernel (``launches`` counts it), CPU tensors take
    :func:`accelerations_tiled_reference`."""
    if positions.device.type == "cpu":
        return accelerations_tiled_reference(positions, masses, softening)
    return _launch_batched("nbody_pairwise_tiled", accelerations_tiled,
                           positions, masses, softening)


def accelerations_small(positions: torch.Tensor, masses: torch.Tensor,
                        softening: float = SOFTENING) -> torch.Tensor:
    """Whole-system accelerations for N <= ``SMALL_MAX_N`` (kernel 4; JAX
    counterpart ``pallas_accelerations_small``, an ensemble being its
    ``vmap``).  positions (N, 3) or (B, N, 3) float32, masses (N,) or
    (B, N); one launch for the whole ensemble (``launches`` counts it).
    CPU tensors take :func:`accelerations_small_reference`."""
    n = positions.shape[-2]
    if n > SMALL_MAX_N:
        raise ValueError(f"accelerations_small takes N <= {SMALL_MAX_N}, "
                         f"got N={n}; use accelerations_tiled or "
                         f"accelerations_symmetric")
    if positions.device.type == "cpu":
        return accelerations_small_reference(positions, masses, softening)
    return _launch_batched("nbody_pairwise_small", accelerations_small,
                           positions, masses, softening)


def _launch_symmetric(symbol: str, wrapper, pos, m, softening):
    """Launch kernel 6 or 5 (the same C signature: one system (1, N, 3), a
    (tiles, N, 3) slot scratch, pair pass + slot sum) and count it once."""
    from nbody_gnn_hpc_torch.ops.cuda_build import load_library

    n = pos.shape[1]
    fn = getattr(load_library("pairwise"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    acc = torch.empty_like(pos)
    partial = torch.empty((-(-n // TILE), n, 3), dtype=torch.float32,
                          device=pos.device)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        rc = fn(pos.data_ptr(), m.data_ptr(), partial.data_ptr(),
                acc.data_ptr(), n, float(softening) ** 2, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return acc[0]


def accelerations_symmetric(positions: torch.Tensor, masses: torch.Tensor,
                            softening: float = SOFTENING) -> torch.Tensor:
    """Newton's-third-law all-pairs accelerations of one system (kernel 6;
    JAX counterpart ``pallas_accelerations_symmetric``): each pair computed
    once.  positions (N, 3) float32, masses (N,) -> (N, 3).  Equal to the
    JAX kernel wherever that is finite; coincident pairs are masked as in
    :func:`accelerations_tiled`, so they stay finite at any mass.  CUDA
    tensors launch the kernel (pair pass + slot sum, counted as one in
    ``launches``), CPU tensors take
    :func:`accelerations_symmetric_reference`."""
    if positions.device.type == "cpu":
        return accelerations_symmetric_reference(positions, masses, softening)
    pos, m = _cuda_operands("accelerations_symmetric", positions, masses,
                            batched_ok=False)
    return _launch_symmetric("nbody_pairwise_symmetric",
                             accelerations_symmetric, pos, m, softening)


def accelerations_symmetric_mxu(positions: torch.Tensor,
                                masses: torch.Tensor,
                                softening: float = SOFTENING) -> torch.Tensor:
    """Symmetric all-pairs accelerations of one system with tensor-core
    moment reductions (kernel 5; JAX counterpart
    ``pallas_accelerations_symmetric_mxu``).  positions (N, 3) float32,
    masses (N,), both contiguous -> (N, 3).  No entry point calls it: the
    moment form's error grows as |x| / |d| for close pairs (the JAX kernel's
    docstring records that as a measured negative result), so the
    simulator dispatches kernel 6.  The wrapper centres the positions; CUDA
    tensors then launch the kernel (pair pass + slot sum, counted as one in
    ``launches``), CPU tensors take
    :func:`accelerations_symmetric_mxu_reference`."""
    if positions.device.type == "cpu":
        return accelerations_symmetric_mxu_reference(positions, masses,
                                                     softening)
    if not (positions.is_contiguous() and masses.is_contiguous()):
        raise ValueError("accelerations_symmetric_mxu takes contiguous "
                         "positions and masses")
    pos, m = _cuda_operands("accelerations_symmetric_mxu", positions, masses,
                            batched_ok=False)
    return _launch_symmetric("nbody_pairwise_symmetric_mma",
                             accelerations_symmetric_mxu,
                             pos - pos.mean(1, keepdim=True), m, softening)


accelerations_tiled.launches = 0
accelerations_small.launches = 0
accelerations_symmetric.launches = 0
accelerations_symmetric_mxu.launches = 0
