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
"""

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from nbody_gnn_hpc_torch.ops.edges import edge_features
from nbody_gnn_hpc_torch.ops.fused_edge import fused_edge_layer, target_csr
from nbody_gnn_hpc_torch.ops.fused_edge_full import fused_full_layer

EDGE_DIM = 5  # distance(1) + direction(3) + inv_dist_sq(1)
LN_EPS = 1e-6  # flax.linen.LayerNorm default
SEED_BOUND = 2_147_483_647  # edge-stream seeds lie in [0, 2^31 - 1)
# "fused": the edge stream as a kernel between PyTorch's projections and
# node MLP; "fused_full": the whole layer as one kernel.
EDGE_IMPLS = ("fused", "fused_full")


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


def _dropout_mask(x: torch.Tensor, p: float,
                  generator: Optional[torch.Generator],
                  rows: Optional[BatchRows] = None) -> torch.Tensor:
    """Pre-scaled mask shaped as ``x`` from the draw :func:`_dropout` makes:
    1/(1-p) with probability 1-p, else 0."""
    keep = draw_rows(torch.rand, x.shape, generator, x.device, rows) >= p
    return keep.to(x.dtype) / (1.0 - p)


def _dropout(x: torch.Tensor, p: float, training: bool,
             generator: Optional[torch.Generator],
             rows: Optional[BatchRows] = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability 1-p, kept / (1-p)."""
    if not training or p <= 0:
        return x
    keep = draw_rows(torch.rand, x.shape, generator, x.device, rows) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


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
    """Linear -> LayerNorm -> SiLU -> Dropout -> Linear."""

    def __init__(self, in_dim: int, hidden: int, out: int, dropout: float):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hidden)
        self.LayerNorm_0 = LayerNorm(hidden)
        self.Dense_1 = nn.Linear(hidden, out)
        self.dropout = dropout

    def forward(self, x, generator=None, rows=None):
        x = F.silu(self.LayerNorm_0(self.Dense_0(x)))
        x = _dropout(x, self.dropout, self.training, generator, rows)
        return self.Dense_1(x)


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
                 edge_dim: int = EDGE_DIM, edge_impl: str = "fused"):
        super().__init__()
        if edge_impl not in EDGE_IMPLS:
            raise ValueError(f"edge_impl must be one of {EDGE_IMPLS}, got "
                             f"{edge_impl!r}")
        self.edge_impl = edge_impl
        self.edge_proj_target = nn.Linear(node_features, hidden_dim)
        self.edge_proj_source = nn.Linear(node_features, hidden_dim,
                                          bias=False)
        self.edge_proj_attr = nn.Linear(edge_dim, hidden_dim, bias=False)
        self.edge_norm = LayerNorm(hidden_dim)
        self.edge_out = nn.Linear(hidden_dim, hidden_dim)
        self.node_mlp = _MLPBlock(node_features + hidden_dim, hidden_dim,
                                  node_features, dropout)
        self.dropout = dropout

    def forward(self, h, edge_attr, edges, deg, generator=None, rows=None):
        seed = None
        if self.training and self.dropout > 0:
            seed = torch.randint(0, SEED_BOUND, (1,), generator=generator,
                                 device=h.device, dtype=torch.int32)
        if self.edge_impl == "fused_full":
            return self._whole_layer(h, edge_attr, edges, seed, generator,
                                     rows)
        summed = self.edge_stream(
            self.edge_proj_target(h), self.edge_proj_source(h), edge_attr,
            self.edge_proj_attr.weight.t().contiguous(),
            self.edge_norm.weight, self.edge_norm.bias, edges, seed,
            dropout_p=self.dropout, deterministic=not self.training)
        # Edge-output Dense pulled through the sum: the (E, H) messages
        # never exist, sum_e (z_e W + b) = (sum_e z_e) W + deg * b.
        agg = summed @ self.edge_out.weight.t() + deg.unsqueeze(-1) * \
            self.edge_out.bias
        return self.node_mlp(torch.cat([h, agg], dim=-1), generator, rows)

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

    def _whole_layer(self, h, edge_attr, edges, seed, generator, rows):
        """The layer through ``full_layer``: the node MLP's dropout mask is
        drawn here, after the edge seed, as ``node_mlp`` would draw it."""
        node_mask = None if seed is None else _dropout_mask(
            h, self.dropout, generator, rows)
        return self.full_layer(h, edge_attr, self.full_layer_params(), edges,
                               seed, node_mask, dropout_p=self.dropout,
                               deterministic=not self.training)


class NBodyGNN(nn.Module):
    """GNN predicting the next state as current_state + delta."""

    def __init__(self, node_input_dim: int = 7, hidden_dim: int = 128,
                 n_layers: int = 3, output_dim: int = 6,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 edge_impl: str = "fused"):
        super().__init__()
        self.edge_impl = edge_impl
        self.node_input_dim = node_input_dim
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        self.output_dim = output_dim
        self.dropout = dropout
        self.node_encoder = _MLPBlock(node_input_dim, hidden_dim, hidden_dim,
                                      dropout)
        self.layers = nn.ModuleList(
            ParticleInteractionLayer(hidden_dim, hidden_dim, dropout,
                                     edge_impl=edge_impl)
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
            h = norm(h + layer(h, edge_attr, edges, deg, generator, rows))
        d = F.silu(self.decoder_0(h))
        d = _dropout(d, self.dropout, self.training, generator, rows)
        d = F.silu(self.decoder_1(d))
        return x[..., :6] + self.decoder_out(d)


def model_from_config(config: dict) -> NBodyGNN:
    """NBodyGNN from a persisted ``model_config`` dict (models/config.json).

    ``edge_impl``: ``"fused_full"`` selects the whole-layer kernel;
    ``"fused"``, the JAX package's ``"auto"`` and ``"xla"``, and a missing
    key select the port's one edge stream; anything else raises.  The port
    computes in float32 whatever ``dtype`` the config names (the serving
    path of the JAX package rebuilds at float32 too); the JAX-only keys
    ``dtype``, ``remat`` and ``gather_mode`` choose nothing here.
    """
    cfg = {k: v for k, v in config.items()
           if k not in ("dtype", "remat", "edge_impl", "gather_mode")}
    edge_impl = config.get("edge_impl", "fused")
    if edge_impl in ("auto", "xla"):
        edge_impl = "fused"
    if edge_impl not in EDGE_IMPLS:
        raise ValueError(f"model_config names edge_impl {edge_impl!r}; the "
                         f"port has {EDGE_IMPLS} (and reads 'auto' and "
                         f"'xla' as 'fused')")
    return NBodyGNN(edge_impl=edge_impl, **cfg)


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
