"""N-body message-passing GNN (port of ``nbody_gnn_hpc_tpu/models/gnn.py``).

Same computation and parameter count as the JAX model (2,550,150 at hidden
256 / 6 layers):

- node encoder Linear(7->H) -> LayerNorm -> SiLU -> Dropout -> Linear(H->H);
- n_layers interaction layers, each followed by residual + LayerNorm.  The
  edge Dense on [h_target, h_source, edge_attr] is decomposed into two node
  projections (``edge_proj_target`` with the bias, ``edge_proj_source``)
  and ``edge_proj_attr``; the edge stream (gather, LayerNorm, SiLU, sum at
  targets) is :func:`~nbody_gnn_hpc_torch.ops.fused_edge.fused_edge_layer`,
  differentiable through the backward kernel;
  the edge-output Dense is pulled through the sum (``summed @ W + deg*b``);
  then node MLP on [h, agg].  With ``edge_impl="fused_full"`` the whole
  layer, projections and node MLP included, is one kernel
  (:func:`~nbody_gnn_hpc_torch.ops.fused_edge_full.fused_full_layer`) over
  the same parameters: one state dict either way;
- decoder Linear(H->H) -> SiLU -> Dropout -> Linear(H->H/2) -> SiLU ->
  Linear(H/2->6), the last zero-initialised; output = state + delta.

Every LayerNorm is Flax's: fast variance, clipped at 0, eps 1e-6.  Weights
start from ``lecun_normal`` (truncated normal, fan-in) as in Flax, so an
untrained port matches the JAX model in distribution.

In training mode every random draw comes from the ``generator`` passed to
:meth:`NBodyGNN.forward`, in a fixed order: the encoder's dropout mask,
then per layer the edge stream's int seed and the node MLP's mask (the same
draws for either ``edge_impl``), then the decoder's mask.  Node-side
dropout is Flax's (keep with probability 1-p, kept values divided by 1-p); the edge stream draws its own mask from
its seed (Philox, :mod:`~nbody_gnn_hpc_torch.ops.fused_edge`).

A data-parallel rank that holds rows [start, start + B) of a batch of
``total`` graphs passes :class:`BatchRows` to :meth:`NBodyGNN.forward`: each
node-side mask is then drawn at the whole batch's shape and this rank's
rows kept, and the edge stream counts graphs from ``start``, so the rank
draws for its rows exactly what one device draws for the whole batch.

``dtype`` is the products' compute dtype, as the JAX model's: with
``torch.bfloat16`` every Dense but ``decoder_out`` casts its input, weight
and bias to bf16 and returns bf16 (cuBLAS on the tensor cores), the edge
stream takes bf16 projections (its bf16 form), and the parameters, the
LayerNorm statistics, the residuals and the sums at the targets stay
float32.  With ``edge_impl="fused_full"`` a bf16 layer is kernel 7's bf16
form, as the JAX model's: ``edge_proj_target`` and ``edge_proj_source``
go in cast to bf16 (so their gradients are rounded to bf16 at that cast,
where JAX rounds them) and the kernel rounds every product operand itself.
Inference rebuilds a model at float32 from the same parameters
(``model_from_config(..., dtype_override="float32")``).
"""

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nbody_gnn_hpc_torch.ops.edges import edge_features
from nbody_gnn_hpc_torch.ops.fused_edge import fused_edge_layer, target_csr
from nbody_gnn_hpc_torch.ops.fused_edge_full import fused_full_layer

EDGE_DIM = 5  # distance(1) + direction(3) + inv_dist_sq(1)
LN_EPS = 1e-6  # flax.linen.LayerNorm default
SEED_BOUND = 2_147_483_647  # edge-stream seeds lie in [0, 2^31 - 1)
# "fused": the edge stream as a kernel between PyTorch's projections and
# node MLP; "fused_full": the whole layer as one kernel.
EDGE_IMPLS = ("fused", "fused_full")
# The compute dtypes, by the names config.json gives them.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BatchRows(NamedTuple):
    """Rows [start, start + B) of a batch of ``total`` graphs: the share of
    a data-parallel rank (:mod:`nbody_gnn_hpc_torch.parallel.train_dp`)."""

    start: int
    total: int


def draw_rows(sampler: Callable, shape, generator: Optional[torch.Generator],
              device, rows: Optional[BatchRows] = None) -> torch.Tensor:
    """``sampler(shape)`` (``torch.rand`` or ``torch.randn``) from
    ``generator``; with ``rows``, the draw is made at the whole batch's
    shape and ``rows`` of it are kept, so the generator advances and the
    values come out as they do for the whole batch."""
    if rows is None:
        return sampler(tuple(shape), generator=generator, device=device)
    whole = sampler((rows.total,) + tuple(shape[1:]), generator=generator,
                    device=device)
    return whole[rows.start:rows.start + shape[0]]


def _dropout(x: torch.Tensor, p: float, training: bool,
             generator: Optional[torch.Generator],
             rows: Optional[BatchRows] = None,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability 1-p, kept / (1-p);
    ``keep``, where given, is the draw (:func:`_keep`), made earlier."""
    if not training or p <= 0:
        return x
    if keep is None:
        keep = _keep(x.shape, p, generator, x.device, rows)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _keep(shape, p: float, generator: Optional[torch.Generator], device,
          rows: Optional[BatchRows] = None) -> torch.Tensor:
    """The bool keep mask :func:`_dropout` draws for ``shape``."""
    return draw_rows(torch.rand, shape, generator, device, rows) >= p


def _dense(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=dtype)``: input, weight and bias cast to
    ``dtype``, the product rounded to ``dtype``, then the bias added in
    ``dtype`` (a second rounding, where a fused bias would round once);
    the float32 layer as it is."""
    if dtype == torch.float32:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm``: var = max(E[x^2] - E[x]^2, 0), eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        return (x - mu) * torch.rsqrt(var + LN_EPS) * self.weight + self.bias


def _lecun_normal_(weight: torch.Tensor, generator=None) -> None:
    """Flax ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in
    after truncation (hence the 0.8796 correction)."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class _MLPBlock(nn.Module):
    """Linear -> LayerNorm -> SiLU -> Dropout -> Linear; the products in
    ``dtype``, the LayerNorm on their float32 cast, the result float32."""

    def __init__(self, in_dim: int, hidden: int, out: int, dropout: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hidden)
        self.LayerNorm_0 = LayerNorm(hidden)
        self.Dense_1 = nn.Linear(hidden, out)
        self.dropout = dropout
        self.dtype = dtype

    def forward(self, x, generator=None, rows=None, keep=None):
        x = F.silu(self.LayerNorm_0(
            _dense(self.Dense_0, x, self.dtype).float()))
        x = _dropout(x, self.dropout, self.training, generator, rows, keep)
        return _dense(self.Dense_1, x, self.dtype).float()


class ParticleInteractionLayer(nn.Module):
    """Message-passing layer: message for edge (row -> col) from
    [h[col], h[row], e], summed at the targets, then node_mlp([h, agg]).

    ``edge_impl`` chooses how it runs (:data:`EDGE_IMPLS`); the parameters
    are the same.  ``edge_stream`` and ``full_layer`` are the functions the
    two ways call; they may be set to
    :func:`~nbody_gnn_hpc_torch.ops.fused_edge.fused_edge_layer_plain` /
    :func:`~nbody_gnn_hpc_torch.ops.fused_edge_full.fused_full_layer_plain`
    on an instance to run the plain versions on the card for comparison."""

    edge_stream = staticmethod(fused_edge_layer)
    full_layer = staticmethod(fused_full_layer)

    def __init__(self, node_features: int, hidden_dim: int, dropout: float,
                 edge_dim: int = EDGE_DIM, edge_impl: str = "fused",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if edge_impl not in EDGE_IMPLS:
            raise ValueError(f"edge_impl must be one of {EDGE_IMPLS}, got "
                             f"{edge_impl!r}")
        self.edge_impl = edge_impl
        self.dtype = dtype
        self.edge_proj_target = nn.Linear(node_features, hidden_dim)
        self.edge_proj_source = nn.Linear(node_features, hidden_dim,
                                          bias=False)
        self.edge_proj_attr = nn.Linear(edge_dim, hidden_dim, bias=False)
        self.edge_norm = LayerNorm(hidden_dim)
        self.edge_out = nn.Linear(hidden_dim, hidden_dim)
        self.node_mlp = _MLPBlock(node_features + hidden_dim, hidden_dim,
                                  node_features, dropout, dtype)
        self.dropout = dropout

    def draws(self, h, generator=None, rows=None):
        """(seed, keep): the layer's random values in training mode, in the
        order the layer uses them: the edge stream's int seed, then the
        node MLP's keep mask; (None, None) in evaluation mode."""
        if not (self.training and self.dropout > 0):
            return None, None
        seed = torch.randint(0, SEED_BOUND, (1,), generator=generator,
                             device=h.device, dtype=torch.int32)
        hidden = self.node_mlp.Dense_0.out_features
        return seed, _keep(h.shape[:-1] + (hidden,), self.dropout, generator,
                           h.device, rows)

    def forward(self, h, edge_attr, edges, deg, generator=None, rows=None,
                draws=None):
        """The layer's new node features (float32), its products in
        ``self.dtype``; ``draws`` are the layer's :meth:`draws`, made
        earlier (else they are drawn here from ``generator``)."""
        dtype = self.dtype
        seed, keep = self.draws(h, generator, rows) if draws is None \
            else draws
        if self.edge_impl == "fused_full":
            return self._whole_layer(h, edge_attr, edges, seed, keep)
        summed = self.edge_stream(
            _dense(self.edge_proj_target, h, dtype),
            _dense(self.edge_proj_source, h, dtype), edge_attr,
            self.edge_proj_attr.weight.t().contiguous(),
            self.edge_norm.weight, self.edge_norm.bias, edges, seed,
            dropout_p=self.dropout, deterministic=not self.training)
        # Edge-output Dense pulled through the sum: the (E, H) messages
        # never exist, sum_e (z_e W + b) = (sum_e z_e) W + deg * b; in bf16
        # the product rounds, deg * b is added in float32.
        w_out = self.edge_out.weight.t()
        if dtype == torch.float32:
            prod = summed @ w_out
        else:
            prod = (summed.to(dtype) @ w_out.to(dtype)).float()
        agg = prod + deg.unsqueeze(-1) * self.edge_out.bias
        return self.node_mlp(torch.cat([h, agg], dim=-1), keep=keep)

    def full_layer_params(self) -> dict:
        """The layer's tensors under the names ``full_layer`` takes."""
        mlp = self.node_mlp
        return dict(
            wt=self.edge_proj_target.weight, bt=self.edge_proj_target.bias,
            ws=self.edge_proj_source.weight, we=self.edge_proj_attr.weight,
            ge=self.edge_norm.weight, be=self.edge_norm.bias,
            wout=self.edge_out.weight, bout=self.edge_out.bias,
            w1=mlp.Dense_0.weight, b1=mlp.Dense_0.bias,
            g1=mlp.LayerNorm_0.weight, be1=mlp.LayerNorm_0.bias,
            w2=mlp.Dense_1.weight, b2=mlp.Dense_1.bias)

    def _whole_layer(self, h, edge_attr, edges, seed, keep):
        """The layer through ``full_layer``: the node MLP's dropout mask is
        the keep mask ``node_mlp`` would apply, pre-scaled.  A bf16 layer
        passes Wt and Ws cast to bf16 (the kernel's bf16 form), the rest
        float32."""
        node_mask = None if seed is None else keep.to(h.dtype) / (
            1.0 - self.dropout)
        params = self.full_layer_params()
        if self.dtype != torch.float32:
            params["wt"] = params["wt"].to(self.dtype)
            params["ws"] = params["ws"].to(self.dtype)
        return self.full_layer(h, edge_attr, params, edges, seed, node_mask,
                               dropout_p=self.dropout,
                               deterministic=not self.training)


class NBodyGNN(nn.Module):
    """GNN predicting the next state as current_state + delta.

    ``dtype``: the products' compute dtype, ``torch.float32`` or
    ``torch.bfloat16`` (or their names); the parameters are float32 either
    way.  ``remat``: recompute each interaction layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    intermediates; the layer's random values are drawn before it, so the
    recompute draws nothing and the results are those without remat.
    The default is ``remat=False``, where the JAX class defaults to True:
    the JAX CLI passes ``--remat`` (off unless given) and
    ``models/config.json`` says false, and a recompute launches each
    layer's forward kernel a second time in every step.
    """

    def __init__(self, node_input_dim: int = 7, hidden_dim: int = 128,
                 n_layers: int = 3, output_dim: int = 6,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 edge_impl: str = "fused", dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        dtype = DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
        if dtype not in DTYPES.values():
            raise ValueError(f"dtype must be one of {list(DTYPES)}, got "
                             f"{dtype!r}")
        self.dtype = dtype
        self.remat = bool(remat)
        self.edge_impl = edge_impl
        self.node_input_dim = node_input_dim
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        self.output_dim = output_dim
        self.dropout = dropout
        self.node_encoder = _MLPBlock(node_input_dim, hidden_dim, hidden_dim,
                                      dropout, dtype)
        self.layers = nn.ModuleList(
            ParticleInteractionLayer(hidden_dim, hidden_dim, dropout,
                                     edge_impl=edge_impl, dtype=dtype)
            for _ in range(n_layers))
        self.norms = nn.ModuleList(LayerNorm(hidden_dim)
                                   for _ in range(n_layers))
        self.decoder_0 = nn.Linear(hidden_dim, hidden_dim)
        self.decoder_1 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.decoder_out = nn.Linear(hidden_dim // 2, output_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax initialisers: lecun_normal kernels, zero biases, unit
        LayerNorm scales; ``decoder_out`` all zeros (delta == 0)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.decoder_out.weight.zero_()
        self.decoder_out.bias.zero_()

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                pos: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rows: Optional[BatchRows] = None) -> torch.Tensor:
        """Args:
            x: (N, node_input_dim) [norm_pos, norm_vel, norm_mass], or
               (B, N, node_input_dim) for a batch of graphs.
            edge_index: (2, E) [source row, target col], shared by the
               batch, or (B, 2, E) per graph.
            pos: positions for the edge features; defaults to x[..., :3].
            generator: source of the dropout draws in training mode (on
               x's device); None draws from PyTorch's default generator.
            rows: where the (B, N, ...) batch lies in a larger one (a
               data-parallel rank's share); the draws are then the larger
               batch's, for these rows.

        Returns: (..., N, output_dim) predicted next state.
        """
        n = x.shape[-2]
        if x.dim() == 3 and edge_index.dim() == 2:
            edge_index = edge_index.expand(x.shape[0], -1, -1)
        if pos is None:
            pos = x[..., :3]
        edge_attr = edge_features(pos, edge_index)  # shared by the layers
        # Shared by the layers; the source-major order only when a
        # backward may need it.
        edges = target_csr(edge_index, n, sources=torch.is_grad_enabled(),
                           graph0=0 if rows is None else rows.start)
        deg = edges.degree if x.dim() == 3 else edges.degree[0]
        h = self.node_encoder(x, generator, rows)
        for layer, norm in zip(self.layers, self.norms):
            draws = layer.draws(h, generator, rows)
            if self.remat and torch.is_grad_enabled():
                h_new = checkpoint(layer, h, edge_attr, edges, deg,
                                   draws=draws, use_reentrant=False)
            else:
                h_new = layer(h, edge_attr, edges, deg, draws=draws)
            h = norm(h + h_new)
        # decoder_0 and decoder_1 in the compute dtype, SiLU in float32;
        # decoder_out float32 (the delta is added at full precision).
        d = F.silu(_dense(self.decoder_0, h, self.dtype).float())
        d = _dropout(d, self.dropout, self.training, generator, rows)
        d = F.silu(_dense(self.decoder_1, d, self.dtype).float())
        return x[..., :6] + self.decoder_out(d)


def model_from_config(config: dict,
                      dtype_override: Optional[str] = None) -> nn.Module:
    """The model of a persisted ``model_config`` dict (models/config.json):
    ``architecture`` ``"gns"`` builds
    :class:`~nbody_gnn_hpc_torch.models.gns.GNS` from its other keys (with
    ``dtype`` and ``dtype_override`` read as below), a missing key builds
    NBodyGNN, anything else raises.

    ``dtype`` ("float32" or "bfloat16", float32 where missing) and
    ``remat`` are read as the JAX ``model_from_config`` reads them;
    ``dtype_override`` replaces the dtype: inference entry points pass
    "float32", as the JAX package's do (the parameters are float32 either
    way, so the same checkpoint serves both).  ``edge_impl``:
    ``"fused_full"`` selects the whole-layer kernel; ``"fused"``, the JAX
    package's ``"auto"`` and ``"xla"``, and a missing key select the port's
    one edge stream; anything else raises.  ``gather_mode`` (an XLA choice)
    chooses nothing here.
    """
    architecture = config.get("architecture")
    dtype = dtype_override or config.get("dtype", "float32")
    if architecture == "gns":
        from nbody_gnn_hpc_torch.models.gns import GNS

        return GNS(dtype=dtype, **{k: v for k, v in config.items()
                                   if k not in ("architecture", "dtype")})
    if architecture is not None:
        raise ValueError(f"model_config names architecture "
                         f"{architecture!r}; the port has 'gns' (and "
                         f"NBodyGNN where the key is missing)")
    cfg = {k: v for k, v in config.items()
           if k not in ("dtype", "remat", "edge_impl", "gather_mode")}
    edge_impl = config.get("edge_impl", "fused")
    if edge_impl in ("auto", "xla"):
        edge_impl = "fused"
    if edge_impl not in EDGE_IMPLS:
        raise ValueError(f"model_config names edge_impl {edge_impl!r}; the "
                         f"port has {EDGE_IMPLS} (and reads 'auto' and "
                         f"'xla' as 'fused')")
    return NBodyGNN(edge_impl=edge_impl, dtype=dtype,
                    remat=bool(config.get("remat", False)), **cfg)


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
