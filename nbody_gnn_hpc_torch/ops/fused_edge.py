"""Fused edge stream of the interaction layer: CUDA kernel + plain version.

Port of ``nbody_gnn_hpc_tpu/ops/fused_edge.py`` (``fused_edge_layer``, the
forward Pallas kernel ``_fwd_kernel``), inference form: float32, no
dropout.  Per graph, with edges (row -> col):

    z    = t_proj[col] + s_proj[row] + edge_attr @ W_e              (E, H)
    y    = LayerNorm(z) * gamma + beta      (fast variance, eps 1e-6)
    a    = silu(y)
    out  = sum of a over the edges into each target                 (N, H)

The TPU kernel's one-hot ``adjT`` matmuls are replaced by a target-major
CSR (:func:`target_csr`): edge ids stably sorted by target, their sources,
and per-target offsets.  It is index bookkeeping, computed once per forward
and shared by every layer.  The kernel (``csrc/fused_edge.cu``) walks each
target's edges in that fixed order, so its sums are deterministic; its
source note states the design and the H100 bound.

:func:`fused_edge_layer` launches the kernel for CUDA tensors and uses
:func:`fused_edge_layer_reference` for CPU tensors; nothing else selects
between them.  Dropout and the backward kernel belong to the training port.
"""

import ctypes
from typing import NamedTuple

import torch

from nbody_gnn_hpc_torch.ops.edges import gather_nodes

EPS = 1e-6  # flax.linen.LayerNorm default
MAX_EDGE_DIM = 8
MAX_HIDDEN = 256


class TargetCSR(NamedTuple):
    """Edges of B graphs, plus their target-major order.

    row, col: (B, E) int64 source / target of each edge.
    perm:     (B, E) int32 edge ids, stably sorted by target.
    src:      (B, E) int32 source of each sorted edge (``row[perm]``).
    offsets:  (B, N+1) int32; target t's edges are perm[offsets[t]:
              offsets[t+1]].
    """

    row: torch.Tensor
    col: torch.Tensor
    perm: torch.Tensor
    src: torch.Tensor
    offsets: torch.Tensor

    @property
    def degree(self) -> torch.Tensor:
        """(B, N) float32 in-degree of every target."""
        return (self.offsets[:, 1:] - self.offsets[:, :-1]).float()


def target_csr(edge_index: torch.Tensor, n_nodes: int) -> TargetCSR:
    """Target-major CSR of ``edge_index`` (2, E) or (B, 2, E)."""
    ei = edge_index if edge_index.dim() == 3 else edge_index.unsqueeze(0)
    row, col = ei[:, 0].long(), ei[:, 1].long()
    sorted_col, perm = torch.sort(col, dim=-1, stable=True)
    bounds = torch.arange(n_nodes + 1, device=col.device).expand(
        col.shape[0], -1).contiguous()
    offsets = torch.searchsorted(sorted_col.contiguous(), bounds)
    return TargetCSR(row=row, col=col, perm=perm.int(),
                     src=torch.gather(row, 1, perm).int(),
                     offsets=offsets.int())


def fused_edge_layer_reference(t_proj, s_proj, edge_attr, w_e, gamma, beta,
                               edges: TargetCSR) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments and result).

    Sums with ``scatter_add_``, which on CUDA uses atomics: it agrees with
    the kernel to float32 reduction order, not bit for bit.
    """
    batched = t_proj.dim() == 3
    tp = t_proj if batched else t_proj.unsqueeze(0)
    sp = s_proj if batched else s_proj.unsqueeze(0)
    ea = edge_attr if batched else edge_attr.unsqueeze(0)
    z = gather_nodes(tp, edges.col) + gather_nodes(sp, edges.row) + ea @ w_e
    mu = z.mean(-1, keepdim=True)
    var = (z * z).mean(-1, keepdim=True) - mu * mu
    y = (z - mu) * torch.rsqrt(var + EPS) * gamma + beta
    a = y * torch.sigmoid(y)
    out = torch.zeros_like(tp).scatter_add_(
        1, edges.col.unsqueeze(-1).expand_as(a), a)
    return out if batched else out[0]


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


def _launch(tp, sp, ea, w_e, gamma, beta, edges: TargetCSR) -> torch.Tensor:
    """Check the (B, N, H) operands and launch ``nbody_fused_edge_fwd``."""
    from nbody_gnn_hpc_torch.ops.cuda_build import load_library

    b, n, h = tp.shape
    e, d = ea.shape[1], ea.shape[2]
    dev = tp.device
    f32, i32 = torch.float32, torch.int32
    if h % 32 or h > MAX_HIDDEN or d > MAX_EDGE_DIM or b > 65535:
        raise ValueError(f"kernel takes H a multiple of 32 up to "
                         f"{MAX_HIDDEN}, D <= {MAX_EDGE_DIM}, B <= 65535; "
                         f"got H={h}, D={d}, B={b}")
    for name, t, dtype, shape in (
            ("t_proj", tp, f32, (b, n, h)), ("s_proj", sp, f32, (b, n, h)),
            ("edge_attr", ea, f32, (b, e, d)), ("w_e", w_e, f32, (d, h)),
            ("gamma", gamma, f32, (h,)), ("beta", beta, f32, (h,)),
            ("perm", edges.perm, i32, (b, e)), ("src", edges.src, i32, (b, e)),
            ("offsets", edges.offsets, i32, (b, n + 1))):
        _check(name, t, dtype, shape, dev)
    lib = load_library("fused_edge")
    fn = lib.nbody_fused_edge_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(tp)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(tp.data_ptr(), sp.data_ptr(), ea.data_ptr(), w_e.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), edges.perm.data_ptr(),
                edges.src.data_ptr(), edges.offsets.data_ptr(),
                out.data_ptr(), b, n, e, d, h, stream)
    if rc != 0:
        raise RuntimeError(f"fused edge kernel launch failed: CUDA error {rc}")
    fused_edge_layer.launches += 1
    return out


def fused_edge_layer(t_proj: torch.Tensor, s_proj: torch.Tensor,
                     edge_attr: torch.Tensor, w_e: torch.Tensor,
                     gamma: torch.Tensor, beta: torch.Tensor,
                     edges: TargetCSR, *, dropout_p: float = 0.0,
                     deterministic: bool = True) -> torch.Tensor:
    """Fused edge stream: (N, H) projections -> (N, H) target sums.

    Args:
        t_proj:    (N, H) or (B, N, H) target-node projection (bias in).
        s_proj:    same shape, source-node projection.
        edge_attr: (E, D) or (B, E, D) edge features, D <= 8.
        w_e:       (D, H) edge-feature projection.
        gamma/beta:(H,) LayerNorm scale / bias.
        edges:     :func:`target_csr` of the graphs' edges.
        dropout_p, deterministic: training-mode dropout is not ported yet
            and raises ``NotImplementedError``.

    CUDA tensors go to the kernel (``launches`` counts each launch); CPU
    tensors go to :func:`fused_edge_layer_reference`.
    """
    if not deterministic and dropout_p > 0:
        raise NotImplementedError(
            "fused_edge_layer: dropout (training mode) and the backward "
            "kernel are not ported yet; call with deterministic=True")
    if t_proj.device.type == "cpu":
        return fused_edge_layer_reference(t_proj, s_proj, edge_attr, w_e,
                                          gamma, beta, edges)
    if t_proj.device.type != "cuda":
        raise ValueError(f"fused_edge_layer runs on cuda or cpu tensors, "
                         f"got {t_proj.device}")
    batched = t_proj.dim() == 3
    lift = (lambda t: t) if batched else (lambda t: t.unsqueeze(0))
    out = _launch(lift(t_proj), lift(s_proj), lift(edge_attr), w_e,
                  gamma, beta, edges)
    return out if batched else out[0]


fused_edge_layer.launches = 0
