"""The receiver sum of a graph network with per-edge state, and the gather
at the receivers that it is the adjoint of.

    receiver_sum(msg, edges)[b, t] = sum of msg[b, e] over e with col == t
    receiver_gather(x, edges)[b, e] = x[b, col[b, e]]

GNS (:mod:`nbody_gnn_hpc_torch.models.gns`) sums its (B, E, F) float32 edge
latents at their receivers twice a layer: forward, into the node MLP, and
backward, as the gradient of the receiver gather that feeds the edge MLP.
PyTorch's ``index_add_`` adds with float atomics on CUDA, in an order that
changes from run to run; the port adds no floats with atomics.  CUDA
tensors go to ``csrc/edge_sum.cu`` (``receiver_sum.launches`` counts each
launch), which walks each target's edges in the order of the target-major
CSR (:func:`~nbody_gnn_hpc_torch.ops.fused_edge.target_csr`), one add after
another, so a step is bit-identical when it is repeated and when its CUDA
graph replays it.  CPU tensors go to :func:`receiver_sum_plain`.  Each is
the other's backward: the gradient of a sum at the receivers is a gather
of the output's gradient at ``col`` (deterministic as it is), that of a
gather the receiver sum of the gradient.
"""

import ctypes

import torch

from nbody_gnn_hpc_torch.ops.edges import gather_nodes
from nbody_gnn_hpc_torch.ops.fused_edge import TargetCSR

MAX_FEATURES = 128  # GNS's latent width: 32 lanes of 4 channels


def receiver_sum_plain(msg: torch.Tensor, edges: TargetCSR) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same arguments and result; on
    any device, for any float dtype.  ``scatter_add_`` on CUDA adds with
    atomics: it agrees with the kernel to float32 reduction order."""
    b, _, f = msg.shape
    n = edges.offsets.shape[1] - 1
    out = msg.new_zeros((b, n, f))
    return out.scatter_add_(1, edges.col.unsqueeze(-1).expand(b, -1, f), msg)


def _launch(msg: torch.Tensor, edges: TargetCSR) -> torch.Tensor:
    """Check the operands and launch ``nbody_receiver_sum``."""
    from nbody_gnn_hpc_torch.ops.cuda_build import load_library

    b, e, f = msg.shape
    n = edges.offsets.shape[1] - 1
    dev = msg.device
    if f % 4 or f > MAX_FEATURES:
        raise ValueError(f"receiver_sum takes a multiple of 4 features up to "
                         f"{MAX_FEATURES}, got {f}")
    for name, t, dtype, shape in (("msg", msg, torch.float32, (b, e, f)),
                                  ("perm", edges.perm, torch.int32, (b, e)),
                                  ("offsets", edges.offsets, torch.int32,
                                   (b, n + 1))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if msg.data_ptr() % 16:
        raise ValueError("receiver_sum reads message rows as float4s: msg "
                         "must start on a 16-byte boundary")
    fn = load_library("edge_sum").nbody_receiver_sum
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, n, f), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(msg.data_ptr(), edges.perm.data_ptr(),
                edges.offsets.data_ptr(), out.data_ptr(), b, n, e, f, stream)
    if rc != 0:
        raise RuntimeError(f"receiver sum kernel launch failed: CUDA error "
                           f"{rc}")
    receiver_sum.launches += 1
    return out


def _sum(msg: torch.Tensor, edges: TargetCSR) -> torch.Tensor:
    if msg.device.type == "cpu":
        return receiver_sum_plain(msg, edges)
    if msg.device.type != "cuda":
        raise ValueError(f"receiver_sum runs on cuda or cpu tensors, got "
                         f"{msg.device}")
    return _launch(msg.contiguous(), edges)


class _ReceiverSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, edges):
        ctx.edges = edges
        return _sum(msg, edges)

    @staticmethod
    def backward(ctx, g_out):
        return gather_nodes(g_out, ctx.edges.col), None


class _ReceiverGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, edges):
        ctx.edges = edges
        return gather_nodes(x, edges.col)

    @staticmethod
    def backward(ctx, g_edge):
        return _sum(g_edge, ctx.edges), None


def receiver_sum(msg: torch.Tensor, edges: TargetCSR) -> torch.Tensor:
    """(B, E, F) float32 edge values -> (B, N, F) float32 sums at their
    receivers ``edges.col``, in the CSR's order; differentiable.  CUDA
    tensors go to the kernel, CPU tensors to :func:`receiver_sum_plain`."""
    return _ReceiverSum.apply(msg, edges)


def receiver_gather(x: torch.Tensor, edges: TargetCSR) -> torch.Tensor:
    """(B, N, F) node values -> (B, E, F), each edge's receiver's row;
    its gradient is :func:`receiver_sum` of the edges' gradient."""
    return _ReceiverGather.apply(x, edges)


receiver_sum.launches = 0
