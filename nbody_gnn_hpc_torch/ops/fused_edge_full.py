"""The whole interaction layer as one CUDA kernel, with its plain versions.

Port of ``nbody_gnn_hpc_tpu/ops/fused_edge_full.py`` (``fused_full_layer``:
the Pallas kernel ``_full_fwd_kernel`` and the ``custom_vjp`` around it).
Per graph, float32:

    t      = h Wt^T + bt ;  s = h Ws^T                            (N, H)
    summed = the edge stream of ops/fused_edge.py over t, s        (N, H)
    agg    = summed Wout^T + deg (x) bout
    z1     = [h, agg] W1^T + b1
    a      = silu(LayerNorm(z1) * g1 + be1) * node_mask   (mask in training)
    h_new  = a W2^T + b2                                           (N, Ho)

The parameters are the interaction layer's own tensors in
``torch.nn.Linear``'s (out, in) layout (:data:`PARAM_KEYS`), so the layer
has one state dict whichever way it runs.  The TPU kernel's one-hot
``adjT``, its padding of N to 8 and of the edge features to 8 columns are
TPU layout and are not carried over: the edges come as the
:class:`~nbody_gnn_hpc_torch.ops.fused_edge.TargetCSR` the edge kernels
take, and the in-degree is read off its offsets.

Forward on CUDA tensors: ``csrc/fused_edge_full.cu`` (its source note has
the design and the H100 bound), six phases (projections, the edge stream,
edge output, first node product, LayerNorm and SiLU, second node product)
in one cooperative launch per layer, or six ordinary launches, one a phase,
where the device has no cooperative launch or :data:`COOPERATIVE` is False;
``fused_full_layer.launches`` counts every launch.  Backward, as in the JAX package: the node side is recomputed and
differentiated in PyTorch from the saved ``summed``, the stream's backward
is kernel 2 (:func:`~nbody_gnn_hpc_torch.ops.fused_edge.fused_edge_backward`)
and the projection backward is matrix products.  CPU tensors run
:func:`fused_full_layer_reference` forward and the same backward through the
plain version of kernel 2.  :func:`fused_full_layer_plain` is the layer
composed of differentiable PyTorch operations on any device: the yardstick
the kernel path is compared with on the card.

The bf16 form (``_build_full(..., bf16_stream)`` of the JAX module, a
bfloat16 model's form) is selected as the JAX wrapper selects it: where
``params["wt"]`` and ``params["ws"]`` are bfloat16 (a mixed pair raises);
the other parameters stay float32.  Every product takes operands rounded
to bf16 and keeps a float32 result, rounded where the TPU kernel rounds::

    t      = bf16(bf16(h Wt^T) + bf16(bt)) ;  s = bf16(h Ws^T)
    summed = kernel 1's bf16 stream over t, s (each term rounded)   float32
    agg    = summed Wout^T + deg (x) bout                     unrounded
    x      = bf16(bf16(h W1h^T + agg W1a^T) + bf16(b1))
    a      = silu(LayerNorm(x) * g1 + be1) * node_mask        float32
    h_new  = bf16(bf16(a W2^T) + bf16(b2))                    as float32

(agg is where it differs from the composed bf16 layer, whose
``_AggregatedDense`` rounds the product).  On CUDA tensors it is
``csrc/fused_edge_full_bf16.cu``, counted apart in
``fused_full_layer.bf16_launches``: its products on the bf16 tensor cores,
wt and ws read in bf16 as the caller passes them.  Its backward is the JAX
custom VJP's, op for op: products of bf16-rounded operands with float32
results, the stream's backward through kernel 2's bf16 form, and d_wt and
d_ws returned in bf16 (the cotangent of the model's cast of the float32
parameters); the other gradients float32.
"""

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nbody_gnn_hpc_torch.ops.fused_edge import (EPS, MAX_EDGE_DIM, MAX_HIDDEN,
                                                TargetCSR, _check,
                                                _dropout_args, _lift,
                                                _round_bf16, _training_seed,
                                                fused_edge_backward,
                                                fused_edge_backward_reference,
                                                fused_edge_layer_plain,
                                                fused_edge_layer_reference)

# The layer's parameters, (out, in) where 2-D: edge_proj_target (wt, bt),
# edge_proj_source (ws), edge_proj_attr (we: (H, D)), edge_norm (ge, be),
# edge_out (wout, bout), node_mlp Dense_0 (w1: (H, 2H), b1), LayerNorm_0
# (g1, be1), Dense_1 (w2: (Ho, H), b2).
PARAM_KEYS = ("wt", "bt", "ws", "we", "ge", "be", "wout", "bout", "w1", "b1",
              "g1", "be1", "w2", "b2")
# One cooperative launch per layer where the device can; False asks for the
# ordinary-launch form (one launch a phase, the same bits).
COOPERATIVE = True
# Phases of the kernel: the launches of the ordinary-launch form.
PHASES = 6
# Timing hook: run only this phase (1 .. PHASES) as one ordinary launch; the
# outputs are then incomplete.  None runs the layer.
PHASE_ALONE: Optional[int] = None


def _layer_norm_silu(z, gamma, beta):
    mu = z.mean(-1, keepdim=True)
    var = (z * z).mean(-1, keepdim=True) - mu * mu
    return F.silu((z - mu) * torch.rsqrt(var + EPS) * gamma + beta)


def _is_bf16(p: Dict[str, torch.Tensor]) -> bool:
    """Whether the layer runs in its bf16 form: ``wt`` and ``ws`` both
    bfloat16 (both float32 for the float32 form; a mixed pair raises)."""
    wt, ws = p["wt"].dtype, p["ws"].dtype
    if wt != ws or wt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"params wt and ws must have one dtype (both float32, "
                        f"or both bfloat16 for the bf16 form), got {wt} and "
                        f"{ws}")
    return wt == torch.bfloat16


def _node_side(h, summed, deg, p: Dict[str, torch.Tensor], node_mask):
    """(N, H) layer input and target sums -> (N, Ho) layer output."""
    hdim = h.shape[-1]
    agg = summed @ p["wout"].t() + deg.unsqueeze(-1) * p["bout"]
    z1 = h @ p["w1"][:, :hdim].t() + agg @ p["w1"][:, hdim:].t() + p["b1"]
    a = _layer_norm_silu(z1, p["g1"], p["be1"])
    if node_mask is not None:
        a = a * node_mask
    return a @ p["w2"].t() + p["b2"]


def _node_side_bf16(h, summed, deg, p: Dict[str, torch.Tensor], node_mask):
    """The node side in the bf16 form (the JAX ``_node_side`` with ``cd =
    bfloat16``): returns h_new and what its backward reads, (agg, xhat, y,
    sigmoid(y), rstd, a before the mask, a after it).  Products of
    bf16-rounded operands, float32 results."""
    r = _round_bf16
    hdim = h.shape[-1]
    agg = r(summed) @ r(p["wout"]).t() + deg.unsqueeze(-1) * p["bout"]
    z1 = (r(h) @ r(p["w1"][:, :hdim]).t()
          + r(agg) @ r(p["w1"][:, hdim:]).t())
    x = r(r(z1) + r(p["b1"]))
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + EPS)
    xhat = (x - mu) * rstd
    y = xhat * p["g1"] + p["be1"]
    sig = torch.sigmoid(y)
    act_pre = y * sig
    act_n = act_pre if node_mask is None else act_pre * node_mask
    h_new = r(r(r(act_n) @ r(p["w2"]).t()) + r(p["b2"]))
    return h_new, (agg, xhat, y, sig, rstd, act_pre, act_n)


def _degree(edges: TargetCSR, batched: bool) -> torch.Tensor:
    return edges.degree if batched else edges.degree[0]


def _projections(h, p, bf16: bool = False):
    """(t_proj, s_proj): float32, or in the bf16 form bfloat16 with the
    TPU kernel's roundings."""
    if not bf16:
        return h @ p["wt"].t() + p["bt"], h @ p["ws"].t()
    r, hc = _round_bf16, _round_bf16(h)
    tp = r(hc @ p["wt"].float().t()) + r(p["bt"])
    return tp.to(torch.bfloat16), (hc @ p["ws"].float().t()).to(torch.bfloat16)


def _layer_output(h, summed, deg, p, node_mask, bf16: bool):
    if bf16:
        return _node_side_bf16(h, summed, deg, p, node_mask)[0]
    return _node_side(h, summed, deg, p, node_mask)


def fused_full_layer_reference(h, edge_attr, params, edges: TargetCSR,
                               seed=None, node_mask=None,
                               dropout_p: float = 0.0):
    """Plain PyTorch version of kernel 7: returns ``(h_new, summed)``.

    ``seed`` (the edge stream's (1,) int32 dropout seed) and ``node_mask``
    (pre-scaled, shaped as ``h``) are None outside training.  Draws the
    kernel's Philox mask; sums with ``scatter_add_`` and PyTorch's matrix
    products, so it agrees with the kernel to float32 summation order.
    bf16 ``wt`` and ``ws`` give the bf16 form (both results float32).
    """
    bf16 = _is_bf16(params)
    tp, sp = _projections(h, params, bf16)
    summed = fused_edge_layer_reference(
        tp, sp, edge_attr, params["we"].t(), params["ge"], params["be"],
        edges, seed, dropout_p)
    return _layer_output(h, summed, _degree(edges, h.dim() == 3), params,
                         node_mask, bf16), summed


# The weight matrices the kernel reads 16 bytes at a time.
_COPIED = ("wt", "ws", "wout", "w1", "w2")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh (16-byte aligned) copy where it starts off 16."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(h, ea, p, edges: TargetCSR, seed, node_mask, dropout_p: float):
    """Check the (B, N, H) operands and launch ``nbody_fused_full_fwd``,
    or ``nbody_fused_full_fwd_bf16`` where ``wt`` and ``ws`` are bfloat16
    (handed to it as they are, in bf16, with its bf16 scratch); returns
    (h_new, summed)."""
    from nbody_gnn_hpc_torch.ops.cuda_build import load_library

    b, n, hdim = h.shape
    e, d = ea.shape[1], ea.shape[2]
    ho = p["w2"].shape[0]
    dev = h.device
    f32, i32 = torch.float32, torch.int32
    bf16 = _is_bf16(p)
    proj = torch.bfloat16 if bf16 else f32
    if hdim % 32 or hdim > MAX_HIDDEN or d > MAX_EDGE_DIM or ho > MAX_HIDDEN:
        raise ValueError(f"kernel takes H a multiple of 32 up to "
                         f"{MAX_HIDDEN}, Ho <= {MAX_HIDDEN}, D <= "
                         f"{MAX_EDGE_DIM}; got H={hdim}, Ho={ho}, D={d}")
    checks = [("h", h, f32, (b, n, hdim)), ("edge_attr", ea, f32, (b, e, d)),
              ("perm", edges.perm, i32, (b, e)),
              ("src", edges.src, i32, (b, e)),
              ("offsets", edges.offsets, i32, (b, n + 1)),
              ("wt", p["wt"], proj, (hdim, hdim)),
              ("bt", p["bt"], f32, (hdim,)),
              ("ws", p["ws"], proj, (hdim, hdim)),
              ("we", p["we"], f32, (hdim, d)),
              ("ge", p["ge"], f32, (hdim,)), ("be", p["be"], f32, (hdim,)),
              ("wout", p["wout"], f32, (hdim, hdim)),
              ("bout", p["bout"], f32, (hdim,)),
              ("w1", p["w1"], f32, (hdim, 2 * hdim)),
              ("b1", p["b1"], f32, (hdim,)), ("g1", p["g1"], f32, (hdim,)),
              ("be1", p["be1"], f32, (hdim,)), ("w2", p["w2"], f32, (ho, hdim)),
              ("b2", p["b2"], f32, (ho,))]
    if seed is not None:
        checks.append(("seed", seed, i32, (1,)))
    if node_mask is not None:
        checks.append(("node_mask", node_mask, f32, (b, n, hdim)))
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    fn = (load_library("fused_edge_full_bf16").nbody_fused_full_fwd_bf16
          if bf16 else load_library("fused_edge_full").nbody_fused_full_fwd)
    fn.argtypes = ([ctypes.c_void_p] * 21
                   + [ctypes.c_uint, ctypes.c_float, ctypes.c_uint]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # The kernel reads these 16 bytes at a time; a view may start anywhere.
    h = _aligned(h)
    p = {k: _aligned(v) if k in _COPIED else v for k, v in p.items()}
    tp, sp, z1, summed = (torch.empty_like(h) for _ in range(4))
    if bf16:  # hb, sb, agg, a (b, n, H) and Wout, W1, W2 in bf16
        agg = torch.empty(4 * b * n * hdim + hdim * (3 * hdim + ho),
                          dtype=torch.bfloat16, device=dev)
    else:
        agg = torch.empty_like(h)
    h_new = torch.empty((b, n, ho), dtype=f32, device=dev)
    seed_ptr, thr, scale = _dropout_args(seed, dropout_p)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(h.data_ptr(), ea.data_ptr(), edges.perm.data_ptr(),
                edges.src.data_ptr(), edges.offsets.data_ptr(),
                *(p[k].data_ptr() for k in PARAM_KEYS),
                None if node_mask is None else node_mask.data_ptr(),
                seed_ptr, thr, scale, edges.graph0, tp.data_ptr(),
                sp.data_ptr(), agg.data_ptr(), z1.data_ptr(), h_new.data_ptr(),
                summed.data_ptr(), b, n, e, d, hdim, ho,
                -PHASE_ALONE if PHASE_ALONE else int(COOPERATIVE),
                ctypes.byref(launched), stream)
    if bf16:
        fused_full_layer.bf16_launches += launched.value
    else:
        fused_full_layer.launches += launched.value
    if rc != 0:
        raise RuntimeError(f"fused full-layer kernel launch failed: CUDA "
                           f"error {rc}")
    return h_new, summed


def _stream_backward_plain(*args, need_d_edge_attr: bool = True):
    """Kernel 2's plain version with :func:`fused_edge_backward`'s
    arguments (on any device)."""
    del need_d_edge_attr
    return fused_edge_backward_reference(*args)


def _backward_f32(h, ea, summed, p, edges, seed, node_mask, dropout_p,
                  g_out, need_d_ea: bool, stream_backward):
    """The float32 form's gradients of h, edge_attr and the parameters (by
    :data:`PARAM_KEYS`): the node side recomputed and differentiated by
    autograd from the saved ``summed``, the stream's backward through
    ``stream_backward`` (kernel 2 or its plain version), the projections'
    as matrix products."""
    node_keys = ("wout", "bout", "w1", "b1", "g1", "be1", "w2", "b2")
    with torch.enable_grad():
        leaves = {k: p[k].detach().requires_grad_() for k in node_keys}
        h_leaf = h.detach().requires_grad_()
        s_leaf = summed.detach().requires_grad_()
        out = _node_side(h_leaf, s_leaf, _degree(edges, h.dim() == 3),
                         leaves, node_mask)
        grads = torch.autograd.grad(
            out, [h_leaf, s_leaf] + [leaves[k] for k in node_keys], g_out)
    d_h, d_summed = grads[0], grads[1]
    d = dict(zip(node_keys, grads[2:]))
    tp, sp = _projections(h, p)
    d_tp, d_sp, d_ea, d_we, d["ge"], d["be"] = stream_backward(
        tp, sp, ea.contiguous(), p["we"].t().contiguous(), p["ge"],
        p["be"], edges, d_summed.contiguous(), seed, dropout_p,
        need_d_edge_attr=need_d_ea)
    d["we"] = d_we.t()
    hdim = h.shape[-1]
    rows = lambda t: t.reshape(-1, hdim)  # noqa: E731
    d["wt"] = rows(d_tp).t() @ rows(h)
    d["bt"] = rows(d_tp).sum(0)
    d["ws"] = rows(d_sp).t() @ rows(h)
    d_h = d_h + d_tp @ p["wt"] + d_sp @ p["ws"]
    return [d_h, d_ea] + [d[k] for k in PARAM_KEYS]


def _backward_bf16(h, ea, summed, p, edges, seed, node_mask, dropout_p,
                   g_out, need_d_ea: bool, stream_backward):
    """The bf16 form's gradients, the JAX ``fused_bwd`` with ``cd =
    bfloat16`` op for op: the node side recomputed with the forward's
    casts, every product on bf16-rounded operands with a float32 result,
    the stream's backward through ``stream_backward`` (kernel 2's bf16 form
    or its plain version).  Returns the gradients of h, edge_attr and the
    parameters (by :data:`PARAM_KEYS`); d_wt and d_ws in bf16, the rest
    float32."""
    r = _round_bf16
    hdim = h.shape[-1]
    rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    deg = _degree(edges, h.dim() == 3)
    _, (agg, xhat, y, sig, rstd, act_pre, act_n) = _node_side_bf16(
        h, summed, deg, p, node_mask)
    d = {}
    gc = r(g_out)
    d["w2"] = rows(gc).t() @ rows(r(act_n))
    d["b2"] = rows(g_out).sum(0)
    d_act = gc @ r(p["w2"])
    if node_mask is not None:
        d_act = d_act * node_mask
    d_y = d_act * (sig * (1.0 + y * (1.0 - sig)))
    d["g1"] = rows(d_y * xhat).sum(0)
    d["be1"] = rows(d_y).sum(0)
    d_xhat = d_y * p["g1"]
    m1 = d_xhat.mean(-1, keepdim=True)
    m2 = (d_xhat * xhat).mean(-1, keepdim=True)
    d_z1 = rstd * (d_xhat - m1 - xhat * m2)
    d["b1"] = rows(d_z1).sum(0)
    d_z1c, hc = r(d_z1), r(h)
    d["w1"] = torch.cat([rows(d_z1c).t() @ rows(hc),
                         rows(d_z1c).t() @ rows(r(agg))], dim=1)
    d_h = d_z1c @ r(p["w1"][:, :hdim])
    d_agg = d_z1c @ r(p["w1"][:, hdim:])
    d["bout"] = rows(d_agg * deg.unsqueeze(-1)).sum(0)
    d_aggc = r(d_agg)
    d["wout"] = rows(d_aggc).t() @ rows(r(summed))
    d_summed = d_aggc @ r(p["wout"])
    tp, sp = _projections(h, p, bf16=True)
    d_tp, d_sp, d_ea, d_we, d["ge"], d["be"] = stream_backward(
        tp, sp, ea.contiguous(), p["we"].t().contiguous(), p["ge"], p["be"],
        edges, d_summed.contiguous(), seed, dropout_p,
        need_d_edge_attr=need_d_ea)
    d["we"] = d_we.t()
    d_tpc, d_spc = d_tp.float(), d_sp.float()
    d["wt"] = (rows(d_tpc).t() @ rows(hc)).to(torch.bfloat16)
    d["bt"] = rows(d_tpc).sum(0)
    d["ws"] = (rows(d_spc).t() @ rows(hc)).to(torch.bfloat16)
    d_h = d_h + d_tpc @ p["wt"].float() + d_spc @ p["ws"].float()
    return [d_h, d_ea] + [d[k] for k in PARAM_KEYS]


class _FullLayer(torch.autograd.Function):
    """Forward: kernel 7 (CUDA) or its plain version (CPU), saving
    ``summed``.  Backward: node side recomputed and differentiated in
    PyTorch, the stream through kernel 2 (or its plain version on the
    CPU), the projections as matrix products; in the bf16 form,
    :func:`_backward_bf16`."""

    @staticmethod
    def forward(ctx, edges, seed, node_mask, dropout_p, h, edge_attr,
                *params):
        p = dict(zip(PARAM_KEYS, params))
        if h.device.type == "cpu":
            h_new, summed = fused_full_layer_reference(
                h, edge_attr, p, edges, seed, node_mask, dropout_p)
        else:
            batched = h.dim() == 3
            h_new, summed = _launch(
                _lift(h.contiguous(), batched),
                _lift(edge_attr.contiguous(), batched),
                {k: v.contiguous() for k, v in p.items()}, edges, seed,
                None if node_mask is None
                else _lift(node_mask.contiguous(), batched), dropout_p)
            if not batched:
                h_new, summed = h_new[0], summed[0]
        ctx.save_for_backward(h, edge_attr, summed, *params)
        ctx.edges, ctx.seed, ctx.node_mask, ctx.dropout_p = (
            edges, seed, node_mask, dropout_p)
        ctx.mark_non_differentiable(summed)
        return h_new, summed

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, _g_summed):
        h, ea, summed, *params = ctx.saved_tensors
        p = dict(zip(PARAM_KEYS, params))
        need = ctx.needs_input_grad
        backward = _backward_bf16 if _is_bf16(p) else _backward_f32
        out_grads = backward(h, ea, summed, p, ctx.edges, ctx.seed,
                             ctx.node_mask, ctx.dropout_p, g_out, need[5],
                             fused_edge_backward)
        return (None,) * 4 + tuple(
            g if need[4 + i] else None for i, g in enumerate(out_grads))


def _prepare(seed, node_mask, dropout_p: float, deterministic: bool):
    """The seed and node mask the layer uses: None unless dropout is on."""
    seed = _training_seed(seed, dropout_p, deterministic)
    if seed is None:
        return None, None
    if node_mask is None:
        raise ValueError("training-mode dropout needs a node_mask")
    return seed, node_mask


def fused_full_layer(h: torch.Tensor, edge_attr: torch.Tensor,
                     params: Dict[str, torch.Tensor], edges: TargetCSR,
                     seed: Optional[torch.Tensor] = None,
                     node_mask: Optional[torch.Tensor] = None, *,
                     dropout_p: float = 0.0,
                     deterministic: bool = True) -> torch.Tensor:
    """One whole interaction layer: (N, H) in -> (N, Ho) out.

    Args:
        h:         (N, H) or (B, N, H) float32 layer input.
        edge_attr: (E, D) or (B, E, D) edge features, D <= 8.
        params:    the layer's tensors under :data:`PARAM_KEYS`.
        edges:     :func:`~nbody_gnn_hpc_torch.ops.fused_edge.target_csr` of
                   the graphs' edges.
        seed:      (1,) int32 dropout seed of the edge stream.
        node_mask: pre-scaled dropout mask of the node MLP, shaped as ``h``
                   (keep / (1 - p)); both are read only in training mode.
        dropout_p, deterministic: dropout rate; no dropout when
                   deterministic.

    Differentiable in ``h``, ``edge_attr`` and every parameter (not in
    ``node_mask``).  ``wt`` and ``ws`` both bfloat16 select the bf16 form
    (the others stay float32; the result is float32 in both forms).  CUDA
    tensors go to the kernel (``launches`` counts every launch of the
    float32 form, ``bf16_launches`` those of the bf16 form), CPU tensors to
    the plain version.
    """
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_full_layer runs on cuda or cpu tensors, "
                         f"got {h.device}")
    seed, node_mask = _prepare(seed, node_mask, dropout_p, deterministic)
    h_new, _ = _FullLayer.apply(edges, seed, node_mask, float(dropout_p), h,
                                edge_attr, *(params[k] for k in PARAM_KEYS))
    return h_new


def fused_full_layer_backward_reference(h, edge_attr, params,
                                        edges: TargetCSR, g_out, seed=None,
                                        node_mask=None,
                                        dropout_p: float = 0.0) -> list:
    """Plain version of :func:`fused_full_layer`'s backward, on any device:
    the gradients of h, edge_attr and the parameters (by
    :data:`PARAM_KEYS`) for the upstream gradient ``g_out``, from
    :func:`fused_full_layer_reference`'s ``summed`` and kernel 2's plain
    version (arguments as :func:`fused_full_layer_reference`'s).  In the
    bf16 form d_wt and d_ws are bf16.  On CPU tensors it is what
    :func:`fused_full_layer`'s backward computes."""
    _, summed = fused_full_layer_reference(h, edge_attr, params, edges, seed,
                                           node_mask, dropout_p)
    backward = _backward_bf16 if _is_bf16(params) else _backward_f32
    return backward(h, edge_attr, summed, params, edges, seed, node_mask,
                    dropout_p, g_out, True, _stream_backward_plain)


def fused_full_layer_plain(h, edge_attr, params, edges: TargetCSR, seed=None,
                           node_mask=None, *, dropout_p: float = 0.0,
                           deterministic: bool = True) -> torch.Tensor:
    """:func:`fused_full_layer` composed of PyTorch operations on any
    device (same masks), differentiated by autograd: the yardstick the
    kernel path is compared with.  In the bf16 form autograd rounds each
    cotangent at each cast, where the custom backward rounds only product
    operands: the kernel path's gradients are held against
    :func:`fused_full_layer_backward_reference` there, not against
    these."""
    seed, node_mask = _prepare(seed, node_mask, dropout_p, deterministic)
    bf16 = _is_bf16(params)
    tp, sp = _projections(h, params, bf16)
    summed = fused_edge_layer_plain(
        tp, sp, edge_attr, params["we"].t(), params["ge"], params["be"],
        edges, seed, dropout_p=dropout_p, deterministic=seed is None)
    return _layer_output(h, summed, _degree(edges, h.dim() == 3), params,
                         node_mask, bf16)


fused_full_layer.launches = 0
fused_full_layer.bf16_launches = 0
