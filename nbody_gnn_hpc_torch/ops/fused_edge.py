"""Fused edge stream of the interaction layer: CUDA kernels + plain versions.

Port of ``nbody_gnn_hpc_tpu/ops/fused_edge.py`` (``fused_edge_layer``: the
forward Pallas kernel ``_fwd_kernel``, the backward ``_bwd_kernel`` and the
``custom_vjp`` around them).  Per graph, with edges (row -> col):

    z    = t_proj[col] + s_proj[row] + edge_attr @ W_e              (E, H)
    y    = LayerNorm(z) * gamma + beta      (fast variance, eps 1e-6)
    a    = silu(y);  in training a = keep ? a / (1-p) : 0
    out  = sum of a over the edges into each target                 (N, H)

The TPU kernel's one-hot ``adjT`` matmuls are replaced by a target-major
CSR (:func:`target_csr`): edge ids stably sorted by target, their sources,
and per-target offsets; the backward also walks a source-major CSR (its
heavy pass, which forms ``d_s_proj``).  Both are index bookkeeping,
computed once per forward and shared by every layer.  The kernels
(``csrc/fused_edge.cuh``) take every sum in a fixed order, so reruns are
bit-identical; its source note states the design and the H100 bounds.

Dropout bits come from Philox4x32-10 keyed on the layer's int seed, one
32-bit word per (graph, original edge id, channel) (:func:`dropout_keep`);
the kernels and the plain versions draw the same bits, and the backward
regenerates the forward's mask from the seed.  The graph is counted from
``TargetCSR.graph0``: a data-parallel rank that holds rows [g0, g0 + B) of
a batch passes g0 and draws the masks a single device draws for them.

:func:`fused_edge_layer` is a ``torch.autograd.Function``: CUDA tensors go
to the kernels (``fused_edge_layer.launches`` and
``fused_edge_backward.launches`` count them), CPU tensors to
:func:`fused_edge_layer_reference` and :func:`fused_edge_backward_reference`.
:func:`fused_edge_layer_plain` runs the plain versions on any device, to
compare a kernel path with its plain path on the card.

The bf16 stream (``_build(..., bf16_stream)`` of the JAX module, a bfloat16
model's form): ``t_proj`` and ``s_proj`` both bfloat16.  The forward rounds
each edge's activation to bf16 after dropout's scale and sums in float32
(its output stays float32); the backward reads ``g_out`` at bf16
precision, rounds dz to bf16 for the target sum only, and returns
``d_t_proj`` and ``d_s_proj`` in bf16, the rest in float32 from the
unrounded dz.  The kernels' bf16 form (``csrc/fused_edge_bf16.cu``) is
counted apart, in ``fused_edge_layer.bf16_launches`` and
``fused_edge_backward.bf16_launches``.
"""

import contextlib
import ctypes
from typing import Iterator, NamedTuple, Optional

import torch

from nbody_gnn_hpc_torch.device import sm_count
from nbody_gnn_hpc_torch.ops.edges import gather_nodes

EPS = 1e-6  # flax.linen.LayerNorm default
MAX_EDGE_DIM = 8
MAX_HIDDEN = 256
WARPS = 8  # most warps a block of the edge-stream kernels

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


class SourceCSR(NamedTuple):
    """Edges in source-major order: ``perm`` (B, E) int32 edge ids stably
    sorted by source, ``dst`` (B, E) int32 their targets, ``offsets``
    (B, N+1) int32."""

    perm: torch.Tensor
    dst: torch.Tensor
    offsets: torch.Tensor


class TargetCSR(NamedTuple):
    """Edges of B graphs, plus their target-major order.

    row, col: (B, E) int64 source / target of each edge.
    perm:     (B, E) int32 edge ids, stably sorted by target.
    src:      (B, E) int32 source of each sorted edge (``row[perm]``).
    offsets:  (B, N+1) int32; target t's edges are perm[offsets[t]:
              offsets[t+1]].
    sources:  the source-major order the backward walks, or None (built
              on demand by the backward).
    graph0:   index of graph 0 in the whole batch, where the edge dropout
              counts graphs from: the first of a data-parallel rank's rows
              (:mod:`nbody_gnn_hpc_torch.parallel.train_dp`), 0 otherwise.
    """

    row: torch.Tensor
    col: torch.Tensor
    perm: torch.Tensor
    src: torch.Tensor
    offsets: torch.Tensor
    sources: Optional[SourceCSR] = None
    graph0: int = 0

    @property
    def degree(self) -> torch.Tensor:
        """(B, N) float32 in-degree of every target."""
        return (self.offsets[:, 1:] - self.offsets[:, :-1]).float()


def _csr(key: torch.Tensor, other: torch.Tensor, n_nodes: int):
    """(perm, other[perm], offsets) of edges stably sorted by ``key``."""
    sorted_key, perm = torch.sort(key, dim=-1, stable=True)
    bounds = torch.arange(n_nodes + 1, device=key.device).expand(
        key.shape[0], -1).contiguous()
    offsets = torch.searchsorted(sorted_key.contiguous(), bounds)
    return perm.int(), torch.gather(other, 1, perm).int(), offsets.int()


def source_csr(row: torch.Tensor, col: torch.Tensor,
               n_nodes: int) -> SourceCSR:
    """Source-major CSR of (B, E) edges."""
    return SourceCSR(*_csr(row, col, n_nodes))


def target_csr(edge_index: torch.Tensor, n_nodes: int,
               sources: bool = False, graph0: int = 0) -> TargetCSR:
    """Target-major CSR of ``edge_index`` (2, E) or (B, 2, E); with
    ``sources`` also the source-major CSR the backward needs; ``graph0``
    as :class:`TargetCSR` has it."""
    if not 0 <= graph0 < 2 ** 31:
        raise ValueError(f"graph0 must lie in [0, 2^31), got {graph0}")
    ei = edge_index if edge_index.dim() == 3 else edge_index.unsqueeze(0)
    row, col = ei[:, 0].long(), ei[:, 1].long()
    perm, src, offsets = _csr(col, row, n_nodes)
    return TargetCSR(row=row, col=col, perm=perm, src=src, offsets=offsets,
                     sources=source_csr(row, col, n_nodes) if sources
                     else None, graph0=int(graph0))


def dropout_threshold(p: float) -> int:
    """uint32 threshold: keep iff bits >= it, P(drop) = p to 2^-32
    (``_threshold`` of the JAX module)."""
    return min(int(round(p * 4294967296.0)), _U32)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the constant ``m`` times uint32 values held
    in int64 ``x``: the 64-bit product would overflow int64, so it is taken
    in 16-bit halves of ``m``."""
    p0 = x * (m & 0xFFFF)            # < 2^48
    p1 = x * (m >> 16)               # < 2^48
    low = p0 + ((p1 & 0xFFFF) << 16)  # < 2^49
    return (p1 >> 16) + (low >> 32), low & _U32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 values (broadcast);
    returns the four output words."""
    k0 = k0 & _U32
    k1 = k1 & _U32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _U32
        k1 = (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def dropout_bits(seed: torch.Tensor, b: int, e: int, h: int,
                 graph0: int = 0) -> torch.Tensor:
    """(B, E, H) int64 uint32 words the kernels draw: for graph b, original
    edge id e and channel c, word (c/32) % 4 of Philox4x32-10 with counter
    (c%32 + 32*(c/128), e, graph0 + b, 0) and key (seed, 0)."""
    dev = seed.device
    c = torch.arange(h, device=dev)
    group = (c % 32 + 32 * (c // 128)).view(1, 1, h)
    word = ((c // 32) % 4).view(1, 1, h)
    eid = torch.arange(e, device=dev).view(1, e, 1)
    bid = (graph0 + torch.arange(b, device=dev)).view(b, 1, 1)
    key = seed.long().reshape(1, 1, 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    shape = (b, e, h)
    words = philox4x32(group.expand(shape), eid.expand(shape),
                       bid.expand(shape), zero, key, zero)
    out = torch.where(word == 0, words[0], words[1])
    out = torch.where(word == 2, words[2], out)
    return torch.where(word == 3, words[3], out)


def dropout_keep(seed: torch.Tensor, p: float, b: int, e: int,
                 h: int, graph0: int = 0) -> torch.Tensor:
    """(B, E, H) bool keep mask of the edge stream (the kernels' bits) for
    graphs graph0 .. graph0 + B - 1 of the batch."""
    return dropout_bits(seed, b, e, h, graph0) >= dropout_threshold(p)


def _lift(t: torch.Tensor, batched: bool) -> torch.Tensor:
    return t if batched else t.unsqueeze(0)


def _is_bf16(t_proj, s_proj) -> bool:
    """Whether the stream is the bf16 one: ``t_proj`` and ``s_proj`` both
    bfloat16.  A mixed pair raises."""
    if t_proj.dtype != s_proj.dtype:
        raise TypeError(f"t_proj and s_proj must have one dtype (both "
                        f"float32, or both bfloat16 for the bf16 stream), "
                        f"got {t_proj.dtype} and {s_proj.dtype}")
    return t_proj.dtype == torch.bfloat16


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to bf16 precision (nearest even), as float32."""
    return x.to(torch.bfloat16).float()


def _stream(tp, sp, ea, w_e, gamma, beta, edges: TargetCSR):
    """(B, E, H) pre-LN stream pieces: x-hat, y, sigmoid(y), rstd, in the
    edge features' dtype (bf16 projections are widened exactly)."""
    z = (gather_nodes(tp, edges.col).to(ea.dtype)
         + gather_nodes(sp, edges.row).to(ea.dtype) + ea @ w_e)
    mu = z.mean(-1, keepdim=True)
    var = (z * z).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + EPS)
    xhat = (z - mu) * rstd
    y = xhat * gamma + beta
    return xhat, y, torch.sigmoid(y), rstd


def _drop_factor(seed, p, shape, graph0):
    """Dropout factor (1/(1-p) or 0) over the (B, E, H) stream, or None."""
    if seed is None or p <= 0:
        return None
    keep = dropout_keep(seed, p, *shape, graph0)
    return torch.where(keep, 1.0 / (1.0 - p), 0.0).float()


def fused_edge_layer_reference(t_proj, s_proj, edge_attr, w_e, gamma, beta,
                               edges: TargetCSR, seed=None,
                               dropout_p: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of kernel 1 (same arguments and result).

    ``seed``: (1,) int32 tensor of the layer's dropout seed, or None (no
    dropout).  Sums with ``scatter_add_``, which on CUDA uses atomics: it
    agrees with the kernel to float32 reduction order, not bit for bit.
    bf16 ``t_proj`` and ``s_proj`` give the bf16 stream: each activation is
    rounded to bf16 after dropout, the sum and the result are float32.
    """
    bf16 = _is_bf16(t_proj, s_proj)
    batched = t_proj.dim() == 3
    tp, sp, ea = (_lift(t, batched) for t in (t_proj, s_proj, edge_attr))
    _, y, sig, _ = _stream(tp, sp, ea, w_e, gamma, beta, edges)
    a = y * sig
    factor = _drop_factor(seed, dropout_p, a.shape, edges.graph0)
    if factor is not None:
        a = a * factor
    if bf16:
        a = _round_bf16(a)
    out = torch.zeros(tp.shape, dtype=a.dtype, device=a.device).scatter_add_(
        1, edges.col.unsqueeze(-1).expand_as(a), a)
    return out if batched else out[0]


def fused_edge_backward_reference(t_proj, s_proj, edge_attr, w_e, gamma,
                                  beta, edges: TargetCSR, g_out, seed=None,
                                  dropout_p: float = 0.0):
    """Plain PyTorch version of kernel 2: the six gradients of
    :func:`fused_edge_layer_reference` for the upstream gradient ``g_out``,
    written out as the JAX ``_bwd_kernel`` forms them.

    Returns (d_t_proj, d_s_proj, d_edge_attr, d_w_e, d_gamma, d_beta),
    shaped as the inputs; the parameter gradients are summed over the
    batch.  The bf16 stream (bf16 ``t_proj`` and ``s_proj``) reads
    ``g_out`` at bf16 precision, sums dz rounded to bf16 into d_t_proj and
    the float32 dz into d_s_proj (both returned in bf16), and forms the
    other four from the float32 dz, as the JAX ``_bwd_kernel`` with
    ``cd = bfloat16``.
    """
    bf16 = _is_bf16(t_proj, s_proj)
    batched = t_proj.dim() == 3
    tp, sp, ea, go = (_lift(t, batched)
                      for t in (t_proj, s_proj, edge_attr, g_out))
    if bf16:
        go = _round_bf16(go)
    h = tp.shape[-1]
    xhat, y, sig, rstd = _stream(tp, sp, ea, w_e, gamma, beta, edges)
    d_act = gather_nodes(go, edges.col)                        # (B, E, H)
    factor = _drop_factor(seed, dropout_p, d_act.shape, edges.graph0)
    if factor is not None:
        d_act = d_act * factor
    d_y = d_act * (sig * (1.0 + y * (1.0 - sig)))
    d_gamma = (d_y * xhat).sum((0, 1))
    d_beta = d_y.sum((0, 1))
    d_xhat = d_y * gamma
    m1 = d_xhat.mean(-1, keepdim=True)
    m2 = (d_xhat * xhat).mean(-1, keepdim=True)
    d_z = rstd * (d_xhat - m1 - xhat * m2)                     # (B, E, H)
    index = lambda ix: ix.unsqueeze(-1).expand(-1, -1, h)  # noqa: E731
    zeros = lambda: torch.zeros(tp.shape, dtype=d_z.dtype,  # noqa: E731
                                device=d_z.device)
    d_tp = zeros().scatter_add_(1, index(edges.col),
                                _round_bf16(d_z) if bf16 else d_z)
    d_sp = zeros().scatter_add_(1, index(edges.row), d_z)
    if bf16:
        d_tp, d_sp = d_tp.to(torch.bfloat16), d_sp.to(torch.bfloat16)
    d_ea = d_z @ w_e.t()
    d_we = torch.einsum("bed,beh->dh", ea, d_z)
    if not batched:
        d_tp, d_sp, d_ea = d_tp[0], d_sp[0], d_ea[0]
    return d_tp, d_sp, d_ea, d_we, d_gamma, d_beta


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(tp, sp, ea, w_e, gamma, beta, edges, seed, extra=()):
    """Check the (B, N, H) operands the kernels take (``t_proj`` and
    ``s_proj`` both float32 or both bfloat16, the rest float32 and int32);
    returns (b, n, e, d, h)."""
    b, n, h = tp.shape
    e, d = ea.shape[1], ea.shape[2]
    dev = tp.device
    f32, i32 = torch.float32, torch.int32
    if h % 32 or h > MAX_HIDDEN or d > MAX_EDGE_DIM or b > 65535:
        raise ValueError(f"kernel takes H a multiple of 32 up to "
                         f"{MAX_HIDDEN}, D <= {MAX_EDGE_DIM}, B <= 65535; "
                         f"got H={h}, D={d}, B={b}")
    stream = torch.bfloat16 if _is_bf16(tp, sp) else f32
    checks = [("t_proj", tp, stream, (b, n, h)),
              ("s_proj", sp, stream, (b, n, h)),
              ("edge_attr", ea, f32, (b, e, d)), ("w_e", w_e, f32, (d, h)),
              ("gamma", gamma, f32, (h,)), ("beta", beta, f32, (h,)),
              ("perm", edges.perm, i32, (b, e)),
              ("src", edges.src, i32, (b, e)),
              ("offsets", edges.offsets, i32, (b, n + 1))]
    if seed is not None:
        checks.append(("seed", seed, i32, (1,)))
    for name, t, dtype, shape in checks + list(extra):
        _check(name, t, dtype, shape, dev)
    return b, n, e, d, h


def _dropout_args(seed, p):
    """(seed pointer, threshold, scale) for the kernels' dropout."""
    if seed is None or p <= 0:
        return None, 0, 1.0
    return seed.data_ptr(), dropout_threshold(p), 1.0 / (1.0 - p)


MAX_CHUNK = 128  # CSR positions a block of kernels 1 and 2
MAX_RUN = 32  # most edges a warp of kernels 1 and 2 walks in a row
FWD_MIN_RUN = 4  # least edges a warp of kernel 1 walks in a row
FWD_WARPS_PER_SM = 16  # warps an SM that kernel 1's grid aims to fill
# Kernel 2's passes keep ~165 registers a thread, so 12 warps fit an SM: its
# grid aims at two rounds of them, in runs of at least 8 edges.
BWD_MIN_RUN, BWD_WARPS_PER_SM = 8, 24


def _walk_schedule(b: int, e: int, sm_count: int, warps_per_sm: int,
                   min_run: int) -> tuple:
    """(chunk, warps) of a walk that aims ``warps_per_sm`` warps at every
    SM: runs as short as give each of them one, within ``min_run``-32
    edges; 8 warps a block for short runs, down to 4 for long ones; no
    more warps than a graph's edges need."""
    run = -(-b * e // (sm_count * warps_per_sm))
    run = min(max(run, min_run), MAX_RUN)
    warps = min(WARPS, max(4, MAX_CHUNK // run), max(1, -(-e // run)))
    return run * warps, warps


def fwd_schedule(b: int, e: int, sm_count: int) -> tuple:
    """(chunk, warps): CSR positions and warps a block of kernel 1.

    Each warp walks a run of ``chunk / warps`` consecutive edges of its
    block's slice, whatever their targets, so the longest chain is set by
    the run, not by the largest in-degree.  The run is as short as keeps
    ``FWD_WARPS_PER_SM`` warps on every SM busy, within 4-32 edges: at B=1
    (N=200, k=40) runs of 4 spread the 8,000 edges over 2,000 warps; from
    B=8 up, runs of 32 pay the block's staging and its arrival at the
    targets it shares with other blocks least often.  A block holds 32-128
    positions: 8 warps for short runs, 4 for long ones (so the grid of B=10
    fits the card in one round).  A function of the batch, the edge count
    and the SM count alone, so reruns on one card are bit-identical.
    """
    return _walk_schedule(b, e, sm_count, FWD_WARPS_PER_SM, FWD_MIN_RUN)


def bwd_schedule(b: int, e: int, sm_count: int) -> tuple:
    """(chunk, warps): CSR positions and warps a block of both passes of
    kernel 2 (the source-major and the target-major pass walk as many
    positions).  As :func:`fwd_schedule`, but aiming ``BWD_WARPS_PER_SM``
    warps at every SM in runs of ``BWD_MIN_RUN`` to 32 edges: at B=1
    (N=200, k=40) runs of 8, 8 warps a block (125 blocks); at B=8 runs of
    21, 6 warps a block (508 blocks, two rounds of 12 warps an SM); from
    B=24 runs of 32, 4 warps a block.  A function of the batch, the edge
    count and the SM count alone, so reruns on one card are bit-identical.
    """
    return _walk_schedule(b, e, sm_count, BWD_WARPS_PER_SM, BWD_MIN_RUN)


# (device index, stream) -> int32 counters, zero between launches.  They
# belong to this process: data-parallel ranks that share one card are
# processes, each with counters of its own.
_ARRIVALS = {}
# (device index, stream) -> the counters of the CUDA graph being captured
# on that stream (:func:`arrivals_from`).
_CAPTURED = {}


def arrival_counters(b: int, e: int, device: torch.device) -> torch.Tensor:
    """Zeroed arrival counters for every launch of kernels 1 and 2 over B
    graphs of E edges on ``device``, for a CUDA graph to own."""
    sms = sm_count(device.index)
    size = max(b * -(-e // schedule(b, e, sms)[0])
               for schedule in (fwd_schedule, bwd_schedule))
    return torch.zeros(size, dtype=torch.int32, device=device)


@contextlib.contextmanager
def arrivals_from(counters: torch.Tensor, stream) -> Iterator[None]:
    """Launches of kernels 1 and 2 on ``stream`` (a ``torch.cuda.Stream``)
    inside the ``with`` block use ``counters``
    (:func:`arrival_counters`): a graph captured there replays with
    counters that no other graph and no eager launch shares."""
    key = (counters.device.index, stream.cuda_stream)
    _CAPTURED[key] = counters
    try:
        yield
    finally:
        del _CAPTURED[key]


def _arrivals(device: torch.device, stream: int, size: int) -> torch.Tensor:
    """The walks' arrival counters (kernels 1 and 2) for launches on
    ``stream``: zero before and after every launch (the kernels reset what
    they count), so they are made once; launches on one stream never
    overlap.  A graph being captured on ``stream`` has its own."""
    key = (device.index, stream)
    buf = _CAPTURED.get(key)
    if buf is not None:
        if buf.numel() < size:
            raise RuntimeError(f"a captured launch needs {size} arrival "
                               f"counters, its graph holds {buf.numel()}")
        return buf
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(max(size, 4096), dtype=torch.int32, device=device)
        _ARRIVALS[key] = buf
    return buf


def _node_index(name, t, b: int, e: int, device) -> torch.Tensor:
    """Check the node of every edge id the walks read: (B, E) int64, unit
    stride along E (row stride 0 where the graphs share their edges)."""
    if (t.dtype != torch.int64 or t.device != device
            or tuple(t.shape) != (b, e) or (e > 1 and t.stride(1) != 1)):
        raise ValueError(f"{name} must be a (B, E) int64 tensor on {device} "
                         f"with unit stride along E")
    return t


def _launch_fwd(tp, sp, ea, w_e, gamma, beta, edges: TargetCSR, seed,
                p: float) -> torch.Tensor:
    """Check the (B, N, H) operands and launch ``nbody_fused_edge_fwd``."""
    from nbody_gnn_hpc_torch.ops.cuda_build import load_library

    b, n, e, d, h = _check_operands(tp, sp, ea, w_e, gamma, beta, edges, seed)
    bf16 = tp.dtype == torch.bfloat16
    col = _node_index("col", edges.col, b, e, tp.device)
    fn = (load_library("fused_edge_bf16").nbody_fused_edge_fwd_bf16 if bf16
          else load_library("fused_edge").nbody_fused_edge_fwd)
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong,
                                             ctypes.c_void_p, ctypes.c_uint,
                                             ctypes.c_float, ctypes.c_uint]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    chunk, warps = fwd_schedule(b, e, sm_count(tp.device.index))
    blocks = max(1, -(-e // chunk))
    out = torch.empty(tp.shape, dtype=torch.float32, device=tp.device)
    part = torch.empty((b, blocks, 2, h), dtype=torch.float32,
                       device=tp.device)
    seed_ptr, thr, scale = _dropout_args(seed, p)
    with torch.cuda.device(tp.device):
        stream = torch.cuda.current_stream(tp.device).cuda_stream
        arrivals = _arrivals(tp.device, stream, b * blocks)
        rc = fn(tp.data_ptr(), sp.data_ptr(), ea.data_ptr(), w_e.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), edges.perm.data_ptr(),
                edges.src.data_ptr(), edges.offsets.data_ptr(),
                col.data_ptr(), col.stride(0) if b else e, seed_ptr, thr,
                scale, edges.graph0, out.data_ptr(), part.data_ptr(), arrivals.data_ptr(),
                b, n, e, d, h, chunk, warps, stream)
    if rc != 0:
        raise RuntimeError(f"fused edge forward kernel launch failed: CUDA "
                           f"error {rc}")
    if bf16:
        fused_edge_layer.bf16_launches += 1
    else:
        fused_edge_layer.launches += 1
    return out


def _launch_bwd(tp, sp, ea, w_e, gamma, beta, edges: TargetCSR, g_out, seed,
                p: float, want_d_ea: bool):
    """Check the operands and launch ``nbody_fused_edge_bwd`` (passes S, T
    and C of kernel 2, counted as one launch)."""
    from nbody_gnn_hpc_torch.ops.cuda_build import load_library

    b, n, h = tp.shape
    e = ea.shape[1]
    sources = edges.sources
    if sources is None:
        sources = source_csr(edges.row, edges.col, n)
    i32 = torch.int32
    b, n, e, d, h = _check_operands(
        tp, sp, ea, w_e, gamma, beta, edges, seed,
        extra=[("g_out", g_out, torch.float32, (b, n, h)),
               ("sperm", sources.perm, i32, (b, e)),
               ("sdst", sources.dst, i32, (b, e)),
               ("soffsets", sources.offsets, i32, (b, n + 1))])
    bf16 = tp.dtype == torch.bfloat16
    col = _node_index("col", edges.col, b, e, tp.device)
    row = _node_index("row", edges.row, b, e, tp.device)
    fn = (load_library("fused_edge_bf16").nbody_fused_edge_bwd_bf16 if bf16
          else load_library("fused_edge").nbody_fused_edge_bwd)
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2
                   + [ctypes.c_uint, ctypes.c_float, ctypes.c_uint]
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    chunk, warps = bwd_schedule(b, e, sm_count(tp.device.index))
    blocks = max(1, -(-e // chunk))
    dev = tp.device
    d_tp = torch.empty_like(tp)
    d_sp = torch.empty_like(sp)
    d_ea = torch.empty_like(ea) if want_d_ea else None
    part = torch.empty((b, blocks, 2, h), dtype=torch.float32, device=dev)
    # Pass S's record of each edge for pass T: 4 scalars and H/32 words of
    # keep bits.
    rec = torch.empty((b, e, 4 + h // 32), dtype=i32, device=dev)
    part_par = torch.empty((b * blocks, d + 2, h), dtype=torch.float32,
                           device=dev)
    d_params = torch.empty((d + 2, h), dtype=torch.float32, device=dev)
    seed_ptr, thr, scale = _dropout_args(seed, p)
    stride = lambda t: t.stride(0) if b else e  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        arrivals = _arrivals(dev, stream, b * blocks)
        rc = fn(tp.data_ptr(), sp.data_ptr(), ea.data_ptr(), w_e.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), edges.perm.data_ptr(),
                edges.src.data_ptr(), edges.offsets.data_ptr(),
                col.data_ptr(), stride(col), sources.perm.data_ptr(),
                sources.dst.data_ptr(), sources.offsets.data_ptr(),
                row.data_ptr(), stride(row), g_out.data_ptr(), seed_ptr, thr,
                scale, edges.graph0, d_tp.data_ptr(), d_sp.data_ptr(),
                None if d_ea is None else d_ea.data_ptr(), part.data_ptr(),
                arrivals.data_ptr(), rec.data_ptr(), part_par.data_ptr(),
                d_params.data_ptr(), b, n, e, d, h, chunk, warps, stream)
    if rc != 0:
        raise RuntimeError(f"fused edge backward kernel launch failed: CUDA "
                           f"error {rc}")
    if bf16:
        fused_edge_backward.bf16_launches += 1
    else:
        fused_edge_backward.launches += 1
    return d_tp, d_sp, d_ea, d_params[:d], d_params[d], d_params[d + 1]


def _training_seed(seed, dropout_p: float, deterministic: bool):
    """The seed the stream uses: None unless dropout is on."""
    if deterministic or dropout_p <= 0:
        return None
    if not 0 < dropout_p < 1:
        raise ValueError(f"dropout_p must lie in [0, 1), got {dropout_p}")
    if seed is None:
        raise ValueError("training-mode dropout needs a seed tensor")
    return seed


def fused_edge_backward(t_proj, s_proj, edge_attr, w_e, gamma, beta,
                        edges: TargetCSR, g_out, seed=None,
                        dropout_p: float = 0.0, need_d_edge_attr: bool = True):
    """Kernel 2 on CUDA tensors (``launches`` counts each call), the plain
    version on CPU tensors; same arguments and results as
    :func:`fused_edge_backward_reference`.  ``d_edge_attr`` is None unless
    ``need_d_edge_attr``."""
    batched = t_proj.dim() == 3
    if t_proj.device.type == "cpu":
        grads = fused_edge_backward_reference(
            t_proj, s_proj, edge_attr, w_e, gamma, beta, edges, g_out, seed,
            dropout_p)
        return grads if need_d_edge_attr else grads[:2] + (None,) + grads[3:]
    if t_proj.device.type != "cuda":
        raise ValueError(f"fused_edge_backward runs on cuda or cpu tensors, "
                         f"got {t_proj.device}")
    tp, sp, ea, go = (_lift(t, batched)
                      for t in (t_proj, s_proj, edge_attr, g_out))
    d_tp, d_sp, d_ea, d_we, d_g, d_b = _launch_bwd(
        tp, sp, ea, w_e, gamma, beta, edges, go.contiguous(), seed,
        dropout_p, need_d_edge_attr)
    if not batched:
        d_tp, d_sp = d_tp[0], d_sp[0]
        d_ea = None if d_ea is None else d_ea[0]
    return d_tp, d_sp, d_ea, d_we, d_g, d_b


class _EdgeStream(torch.autograd.Function):
    """Forward: kernel 1 (CUDA) or the plain version (CPU, or ``plain``).
    Backward: kernel 2 or its plain version.  Saves only the inputs, the
    CSR and the seed, as the JAX custom VJP does.  d_t_proj and d_s_proj
    come back in the projections' dtype."""

    @staticmethod
    def forward(ctx, t_proj, s_proj, edge_attr, w_e, gamma, beta, edges,
                seed, dropout_p, plain):
        ctx.save_for_backward(t_proj, s_proj, edge_attr, w_e, gamma, beta)
        ctx.edges, ctx.seed, ctx.dropout_p, ctx.plain = (edges, seed,
                                                         dropout_p, plain)
        if plain or t_proj.device.type == "cpu":
            return fused_edge_layer_reference(t_proj, s_proj, edge_attr, w_e,
                                              gamma, beta, edges, seed,
                                              dropout_p)
        batched = t_proj.dim() == 3
        out = _launch_fwd(_lift(t_proj, batched), _lift(s_proj, batched),
                          _lift(edge_attr, batched), w_e, gamma, beta, edges,
                          seed, dropout_p)
        return out if batched else out[0]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        args = ctx.saved_tensors + (ctx.edges, g_out, ctx.seed,
                                    ctx.dropout_p)
        if ctx.plain:
            grads = fused_edge_backward_reference(*args)
        else:
            grads = fused_edge_backward(
                *args, need_d_edge_attr=ctx.needs_input_grad[2])
        need = ctx.needs_input_grad
        return tuple(g if need[i] else None
                     for i, g in enumerate(grads)) + (None,) * 4


def fused_edge_layer(t_proj: torch.Tensor, s_proj: torch.Tensor,
                     edge_attr: torch.Tensor, w_e: torch.Tensor,
                     gamma: torch.Tensor, beta: torch.Tensor,
                     edges: TargetCSR, seed: Optional[torch.Tensor] = None,
                     *, dropout_p: float = 0.0,
                     deterministic: bool = True) -> torch.Tensor:
    """Fused edge stream: (N, H) projections -> (N, H) target sums.

    Args:
        t_proj:    (N, H) or (B, N, H) target-node projection (bias in):
                   float32, or bfloat16 for the bf16 stream.
        s_proj:    same shape and dtype, source-node projection.
        edge_attr: (E, D) or (B, E, D) edge features, D <= 8.
        w_e:       (D, H) edge-feature projection.
        gamma/beta:(H,) LayerNorm scale / bias.
        edges:     :func:`target_csr` of the graphs' edges.
        seed:      (1,) int32 dropout seed on the tensors' device (read
                   only in training mode).
        dropout_p, deterministic: dropout rate; no dropout when
                   deterministic.

    Differentiable in every tensor argument.  CUDA tensors go to the
    kernels (``launches`` counts each forward launch,
    ``fused_edge_backward.launches`` each backward; ``bf16_launches`` on
    each, those of the bf16 stream); CPU tensors go to the plain versions.
    The result is float32 in both streams.
    """
    if t_proj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_edge_layer runs on cuda or cpu tensors, "
                         f"got {t_proj.device}")
    seed = _training_seed(seed, dropout_p, deterministic)
    return _EdgeStream.apply(t_proj, s_proj, edge_attr, w_e, gamma, beta,
                             edges, seed, float(dropout_p), False)


def fused_edge_layer_plain(t_proj, s_proj, edge_attr, w_e, gamma, beta,
                           edges: TargetCSR, seed=None, *,
                           dropout_p: float = 0.0,
                           deterministic: bool = True) -> torch.Tensor:
    """:func:`fused_edge_layer` through the plain versions on any device
    (same masks): the yardstick a kernel path is compared with."""
    seed = _training_seed(seed, dropout_p, deterministic)
    return _EdgeStream.apply(t_proj, s_proj, edge_attr, w_e, gamma, beta,
                             edges, seed, float(dropout_p), True)


fused_edge_layer.launches = 0
fused_edge_backward.launches = 0
fused_edge_layer.bf16_launches = 0
fused_edge_backward.bf16_launches = 0
