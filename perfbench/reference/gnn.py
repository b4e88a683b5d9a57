"""Plain PyTorch reference of the N-body GNN: the model's math written out
from its published description, with no kernel, cache or batching trick.

Parameters are a flat dict in the Flax layout of the checkpoints
(``layer_0/edge_proj_target/kernel`` is (in, out), a LayerNorm's ``scale``
and ``bias``).  Every product goes through :func:`dense`, whose ``prec``
says how its operands are rounded:

- ``float32``: full float32 (TF32 off);
- ``tf32``: both operands rounded to TF32's 10-bit mantissa first (the
  precision below float32);
- ``bfloat16``: operands and bias in bf16, the product rounded to bf16, then
  the bias added in bf16 (Flax ``Dense(dtype=bfloat16)``); the edge stream
  takes bf16 projections and rounds each activation to bf16;
- ``int8``: activations rounded to int8 with a scale per row, kernels with a
  scale per output channel, the product and the bias in float32 (the
  precision below bf16).

A layer:  z_e = t[target] + s[source] + e_attr @ W_e;  a_e = SiLU(LN(z_e))
with the edge dropout;  agg = (sum_e a_e) @ W_out + deg * b_out;
h_new = MLP([h, agg]);  h <- LN(h + h_new).  Dropout draws come from the
caller (:func:`draw_step`), in the order the model makes them.
"""

from typing import Dict, List, Optional

import torch

from perfbench.reference.philox import edge_keep

LN_EPS = 1e-6
SEED_BOUND = 2_147_483_647
PRECISIONS = ("float32", "tf32", "bfloat16", "int8")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest-even at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def fake_int8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to int8 with a symmetric scale per slice along
    ``dim`` (the max over ``dim`` / 127), returned dequantized."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          prec: str) -> torch.Tensor:
    """x @ w + b in precision ``prec``; float32 out (bf16 for
    ``bfloat16``, as the Flax layer returns it)."""
    if prec == "bfloat16":
        y = x.to(torch.bfloat16) @ w.to(torch.bfloat16)
        return y if b is None else y + b.to(torch.bfloat16)
    if prec == "tf32":
        x, w = round_tf32(x.float()), round_tf32(w)
    elif prec == "int8":
        x, w = fake_int8(x.float(), -1), fake_int8(w, 0)
    y = x.float() @ w
    return y if b is None else y + b


def layer_norm(x, scale, bias, clip_var: bool = True):
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    if clip_var:
        var = var.clamp_min(0.0)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def dropout(x, keep, p: float):
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def edge_features(pos, row, col):
    """(G, E, 5) [dist, direction, 1/(dist^2 + 1e-6)] of edges row -> col."""
    diff = gather(pos, col) - gather(pos, row)
    dist = torch.linalg.vector_norm(diff, dim=-1, keepdim=True) + 1e-8
    return torch.cat([dist, diff / dist, 1.0 / (dist ** 2 + 1e-6)], -1)


def gather(x, index):
    """x (G, N, F) at index (G, E) -> (G, E, F)."""
    return torch.gather(x, 1, index.unsqueeze(-1).expand(-1, -1,
                                                         x.shape[-1]))


def scatter_sum(values, index, n):
    """Sum (G, E, F) values at index (G, E) into (G, n, F)."""
    out = values.new_zeros(values.shape[0], n, values.shape[-1])
    return out.index_add_(1, index[0], values) if values.shape[0] == 1 \
        else out.scatter_add_(1, index.unsqueeze(-1).expand_as(values),
                              values)


def _mlp(params, name, x, prec, keep, p):
    """Dense -> LayerNorm -> SiLU -> dropout -> Dense, float32 out."""
    y = dense(x, params[f"{name}/Dense_0/kernel"],
              params[f"{name}/Dense_0/bias"], prec).float()
    y = torch.nn.functional.silu(layer_norm(
        y, params[f"{name}/LayerNorm_0/scale"],
        params[f"{name}/LayerNorm_0/bias"]))
    y = dropout(y, keep, p)
    return dense(y, params[f"{name}/Dense_1/kernel"],
                 params[f"{name}/Dense_1/bias"], prec).float()


def _layer(params, i, h, eattr, row, col, deg, prec, draws, p, graph0):
    pre = f"layer_{i}"
    seed, keep = draws if draws is not None else (None, None)
    t = dense(h, params[f"{pre}/edge_proj_target/kernel"],
              params[f"{pre}/edge_proj_target/bias"], prec)
    s = dense(h, params[f"{pre}/edge_proj_source/kernel"], None, prec)
    z = (gather(t, col).float() + gather(s, row).float()
         + eattr @ params[f"{pre}/edge_proj_attr/kernel"])
    a = torch.nn.functional.silu(layer_norm(
        z, params[f"{pre}/edge_norm/scale"], params[f"{pre}/edge_norm/bias"],
        clip_var=False))
    if seed is not None:
        keep_e = edge_keep(seed, p, a.shape[0], a.shape[1], a.shape[2],
                           graph0)
        a = torch.where(keep_e, a / (1.0 - p), torch.zeros_like(a))
    if prec == "bfloat16":
        a = a.to(torch.bfloat16).float()
    summed = scatter_sum(a, col, h.shape[1])
    w_out = params[f"{pre}/edge_out/kernel"]
    agg = dense(summed, w_out, None, prec).float() \
        + deg.unsqueeze(-1) * params[f"{pre}/edge_out/bias"]
    return _mlp(params, f"{pre}/node_mlp", torch.cat([h, agg], -1), prec,
                keep, p)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            pos: torch.Tensor, edge_index: torch.Tensor, n_layers: int,
            prec: str = "float32", draws: Optional[dict] = None,
            p: float = 0.0, graph0: int = 0) -> torch.Tensor:
    """Next state (G, N, 6) of x (G, N, 7) on edges (G, 2, E) or (2, E);
    ``draws`` (:func:`draw_step`'s, for these G graphs) switch dropout on,
    ``graph0`` is the first graph's index in the batch the edge dropout
    counts."""
    g, n = x.shape[0], x.shape[1]
    if edge_index.dim() == 2:
        edge_index = edge_index.expand(g, -1, -1)
    row, col = edge_index[:, 0].long(), edge_index[:, 1].long()
    eattr = edge_features(pos, row, col)
    deg = torch.zeros(g, n, device=x.device).scatter_add_(
        1, col, torch.ones_like(col, dtype=torch.float32))
    d = draws or {}
    h = _mlp(params, "node_encoder", x, prec, d.get("encoder"), p)
    for i in range(n_layers):
        layer_draws = d["layers"][i] if draws else None
        h_new = _layer(params, i, h, eattr, row, col, deg, prec, layer_draws,
                       p, graph0)
        h = layer_norm(h + h_new, params[f"norm_{i}/scale"],
                       params[f"norm_{i}/bias"])
    y = torch.nn.functional.silu(dense(
        h, params["decoder_0/kernel"], params["decoder_0/bias"], prec)
        .float())
    y = dropout(y, d.get("decoder"), p)
    y = torch.nn.functional.silu(dense(
        y, params["decoder_1/kernel"], params["decoder_1/bias"], prec)
        .float())
    return x[..., :6] + y @ params["decoder_out/kernel"] \
        + params["decoder_out/bias"]


def draw_step(generator: torch.Generator, b: int, n: int, hidden: int,
              n_layers: int, p: float, device) -> dict:
    """A training step's random values, drawn from ``generator`` in the
    order the model and its step make them: the input noise (B, N, 6),
    the encoder's keep mask, each layer's edge seed and node keep mask, the
    decoder's keep mask."""
    rand = lambda: torch.rand((b, n, hidden), generator=generator,  # noqa
                              device=device) >= p
    noise = torch.randn((b, n, 6), generator=generator, device=device)
    encoder = rand()
    layers: List[tuple] = []
    for _ in range(n_layers):
        seed = torch.randint(0, SEED_BOUND, (1,), generator=generator,
                             device=device, dtype=torch.int32)
        layers.append((seed, rand()))
    return {"noise": noise, "encoder": encoder, "layers": layers,
            "decoder": rand()}


def rows_of(draws: dict, lo: int, hi: int) -> dict:
    """The draws of graphs [lo, hi) of the batch (the seeds are shared)."""
    return {"noise": draws["noise"][lo:hi],
            "encoder": draws["encoder"][lo:hi],
            "layers": [(s, k[lo:hi]) for s, k in draws["layers"]],
            "decoder": draws["decoder"][lo:hi]}


def param_shapes(node_in: int, hidden: int, n_layers: int, out: int,
                 edge_dim: int = 5) -> Dict[str, tuple]:
    """Every parameter of the model by its Flax name, in (in, out)
    layout."""
    h = hidden
    shapes: Dict[str, tuple] = {}

    def mlp(name, i, o):
        shapes.update({f"{name}/Dense_0/kernel": (i, h),
                       f"{name}/Dense_0/bias": (h,),
                       f"{name}/LayerNorm_0/scale": (h,),
                       f"{name}/LayerNorm_0/bias": (h,),
                       f"{name}/Dense_1/kernel": (h, o),
                       f"{name}/Dense_1/bias": (o,)})

    mlp("node_encoder", node_in, h)
    for i in range(n_layers):
        pre = f"layer_{i}"
        shapes.update({f"{pre}/edge_proj_target/kernel": (h, h),
                       f"{pre}/edge_proj_target/bias": (h,),
                       f"{pre}/edge_proj_source/kernel": (h, h),
                       f"{pre}/edge_proj_attr/kernel": (edge_dim, h),
                       f"{pre}/edge_norm/scale": (h,),
                       f"{pre}/edge_norm/bias": (h,),
                       f"{pre}/edge_out/kernel": (h, h),
                       f"{pre}/edge_out/bias": (h,)})
        mlp(f"{pre}/node_mlp", 2 * h, h)
        shapes.update({f"norm_{i}/scale": (h,), f"norm_{i}/bias": (h,)})
    shapes.update({"decoder_0/kernel": (h, h), "decoder_0/bias": (h,),
                   "decoder_1/kernel": (h, h // 2),
                   "decoder_1/bias": (h // 2,),
                   "decoder_out/kernel": (h // 2, out),
                   "decoder_out/bias": (out,)})
    return shapes
