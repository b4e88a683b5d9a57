"""GNS, the Graph Network-based Simulator (Sanchez-Gonzalez et al.,
"Learning to Simulate Complex Physics with Graph Networks", ICML 2020,
arXiv 2002.09405; deepmind-research ``learning_to_simulate``), on the
port's N-body data and training step.

Encode-process-decode (``graph_network.py``'s ``EncodeProcessDecode``),
every MLP Linear -> ReLU -> ... -> Linear with ``mlp_num_hidden_layers``
hidden layers of ``mlp_hidden_size``, "MLP+LN" one followed by LayerNorm:

- node input ``x[..., 3:7]``: the normalised velocity and the mass feature
  (no absolute position, so the model is translation invariant); edge
  input: the sender's minus the receiver's position and its norm;
- encoder: MLP+LN on nodes and on edges, to ``latent_size``;
- ``num_message_passing_steps`` steps with unshared weights, each
  ``e' = MLP+LN([e, v[sender], v[receiver]])``, ``agg = receiver_sum(e')``,
  ``v' = MLP+LN([v, agg])``, then ``e += e'`` and ``v += v'``;
- decoder: MLP to ``output_dim`` without LayerNorm; the output is
  ``x[..., :6] + decoder(v)``, the next state as :class:`NBodyGNN` gives it.

The edge MLP reads the (E, 3L) concatenation as the paper writes it, in
the products' dtype, so its first product rounds where the published
model's does.  The sender gather is a broadcast over the row-regular
layout (edge ``i * k + j`` leaves node ``i``, as every builder in
:mod:`~nbody_gnn_hpc_torch.ops.knn` emits), so its gradient is a sum over
k; the receiver gather's gradient and the aggregation are
:mod:`~nbody_gnn_hpc_torch.ops.edge_sum`'s receiver sum.  No float is
added with atomics, so a step repeats bit for bit.

``dtype`` is the products' compute dtype, as in :class:`NBodyGNN`: with
``torch.bfloat16`` every Dense but the decoder's last casts its input,
weight and bias to bf16 and returns bf16 (a ReLU between two Denses keeps
it, which rounds nothing); the parameters, the LayerNorm statistics, the
edge and node latents, their residuals and the receiver sums stay float32,
and so does the decoder's last product (the delta is added at full
precision).  Weights start as Sonnet's ``Linear`` (truncated normal,
stddev 1/sqrt(fan_in)), biases at zero.  GNS has no dropout: the forward
draws nothing, and the training step's noise is its only draw.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nbody_gnn_hpc_torch.models.gnn import DTYPES, LayerNorm, _dense
from nbody_gnn_hpc_torch.ops.edge_sum import receiver_gather, receiver_sum
from nbody_gnn_hpc_torch.ops.edges import gather_nodes
from nbody_gnn_hpc_torch.ops.fused_edge import target_csr
from nbody_gnn_hpc_torch.utils.profiling import annotate

NODE_IN = 4  # normalised velocity (3) and the mass feature
EDGE_IN = 4  # sender minus receiver position (3) and its norm


class MLP(nn.Module):
    """Linear -> ReLU -> ... -> Linear (``Dense_0`` .. ``Dense_{hidden}``),
    then ``LayerNorm_0`` where ``layer_norm``; float32 out."""

    def __init__(self, in_dim: int, hidden: int, n_hidden: int, out: int,
                 layer_norm: bool = True, dtype=torch.float32):
        super().__init__()
        widths = [in_dim] + [hidden] * n_hidden + [out]
        for i in range(len(widths) - 1):
            self.add_module(f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))
        self.n_dense = len(widths) - 1
        self.LayerNorm_0 = LayerNorm(out) if layer_norm else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor, last_dtype=None) -> torch.Tensor:
        """The MLP on ``x``; the last Dense in ``last_dtype`` where given.
        Each ReLU runs on its input cast to the next product's dtype:
        rounding commutes with it, and the one tensor is what both keep
        for the backward."""
        y = x
        for i in range(self.n_dense):
            dtype = last_dtype if (last_dtype is not None
                                   and i == self.n_dense - 1) else self.dtype
            if i:
                y = F.relu(y.to(dtype))
            y = _dense(getattr(self, f"Dense_{i}"), y, dtype)
        y = y.float()
        return y if self.LayerNorm_0 is None else self.LayerNorm_0(y)


class InteractionStep(nn.Module):
    """One message-passing step: ``edge_mlp`` on [e, v[sender],
    v[receiver]], the receiver sum, ``node_mlp`` on [v, agg]; returns the
    new edge and node latents with their residuals."""

    def __init__(self, latent: int, hidden: int, n_hidden: int, dtype):
        super().__init__()
        self.edge_mlp = MLP(3 * latent, hidden, n_hidden, latent, True, dtype)
        self.node_mlp = MLP(2 * latent, hidden, n_hidden, latent, True, dtype)
        self.latent, self.dtype = latent, dtype

    def edge_input(self, e, v, edges, k: int) -> torch.Tensor:
        """[e, v[sender], v[receiver]] (B, E, 3L), each piece cast to the
        products' dtype (the cast the first Dense makes).  The sender's is
        a broadcast over the row-regular layout, the receiver's
        :func:`~nbody_gnn_hpc_torch.ops.edge_sum.receiver_gather`; both
        gather float32 latents, so their gradients sum in float32."""
        b, n, lat = v.shape
        s = v.unsqueeze(2).expand(b, n, k, lat).reshape(b, n * k, lat)
        r = receiver_gather(v, edges)
        return torch.cat([t.to(self.dtype) for t in (e, s, r)], dim=-1)

    def forward(self, e, v, edges, k: int):
        e_new = self.edge_mlp(self.edge_input(e, v, edges, k))
        agg = receiver_sum(e_new, edges)
        v_new = self.node_mlp(torch.cat([v, agg], dim=-1))
        return e + e_new, v + v_new


class GNS(nn.Module):
    """GNS with the :class:`NBodyGNN` forward signature: (…, N, 7) inputs
    [norm_pos, norm_vel, norm_mass] -> (…, N, output_dim) next state.

    ``latent_size``, ``mlp_hidden_size``, ``mlp_num_hidden_layers`` and
    ``num_message_passing_steps`` as ``learning_to_simulate/train.py``
    names them (published: 128, 128, 2, 10); ``dtype`` the products'
    compute dtype (:data:`~nbody_gnn_hpc_torch.models.gnn.DTYPES`).
    """

    architecture = "gns"

    def __init__(self, latent_size: int = 128, mlp_hidden_size: int = 128,
                 mlp_num_hidden_layers: int = 2,
                 num_message_passing_steps: int = 10, output_dim: int = 6,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dtype = DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
        if dtype not in DTYPES.values():
            raise ValueError(f"dtype must be one of {list(DTYPES)}, got "
                             f"{dtype!r}")
        self.dtype = dtype
        self.latent_size = latent_size
        self.mlp_hidden_size = mlp_hidden_size
        self.mlp_num_hidden_layers = mlp_num_hidden_layers
        self.num_message_passing_steps = num_message_passing_steps
        self.output_dim = output_dim
        mlp = lambda i, o, ln=True: MLP(  # noqa: E731
            i, mlp_hidden_size, mlp_num_hidden_layers, o, ln, dtype)
        self.node_encoder = mlp(NODE_IN, latent_size)
        self.edge_encoder = mlp(EDGE_IN, latent_size)
        self.layers = nn.ModuleList(
            InteractionStep(latent_size, mlp_hidden_size,
                            mlp_num_hidden_layers, dtype)
            for _ in range(num_message_passing_steps))
        self.decoder = mlp(latent_size, output_dim, ln=False)
        self.reset_parameters(generator)

    @property
    def model_config(self) -> dict:
        """The ``model_config`` that :func:`~nbody_gnn_hpc_torch.models.
        model_from_config` builds this model from."""
        return {"architecture": self.architecture,
                "latent_size": self.latent_size,
                "mlp_hidden_size": self.mlp_hidden_size,
                "mlp_num_hidden_layers": self.mlp_num_hidden_layers,
                "num_message_passing_steps": self.num_message_passing_steps,
                "output_dim": self.output_dim}

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Sonnet's ``Linear``: weights truncated normal at +-2 std, std
        1/sqrt(fan_in); biases zero; LayerNorm scales one."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                std = 1.0 / math.sqrt(m.weight.shape[1])
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                pos: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rows=None) -> torch.Tensor:
        """As :meth:`NBodyGNN.forward`; ``edge_index`` must be row-regular
        (E = N k, edge ``i * k + j`` leaving node ``i``).  ``generator``
        and ``rows`` are taken for the signature's sake: GNS draws
        nothing."""
        del generator, rows
        batched = x.dim() == 3
        if not batched:
            x = x.unsqueeze(0)
            edge_index = edge_index.unsqueeze(0)
            pos = None if pos is None else pos.unsqueeze(0)
        b, n = x.shape[0], x.shape[1]
        if edge_index.dim() == 2:
            edge_index = edge_index.expand(b, -1, -1)
        if pos is None:
            pos = x[..., :3]
        n_edges = edge_index.shape[-1]
        if n_edges % n:
            raise ValueError(f"GNS takes row-regular edges (E a multiple of "
                             f"N), got E={n_edges}, N={n}")
        k = n_edges // n
        with annotate("gns.encode"):
            edges = target_csr(edge_index, n)
            send = pos.unsqueeze(2).expand(b, n, k, 3).reshape(b, n_edges, 3)
            rel = send - gather_nodes(pos, edges.col)
            edge_in = torch.cat(
                [rel, torch.linalg.vector_norm(rel, dim=-1, keepdim=True)], -1)
            v = self.node_encoder(x[..., 3:7])
            e = self.edge_encoder(edge_in)
        with annotate("gns.process", layers=len(self.layers), edges=n_edges):
            for layer in self.layers:
                e, v = layer(e, v, edges, k)
        with annotate("gns.decode"):
            out = x[..., :6] + self.decoder(v, last_dtype=torch.float32)
        return out if batched else out[0]
