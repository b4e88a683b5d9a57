"""Plain PyTorch reference of GNS (Sanchez-Gonzalez et al., ICML 2020,
arXiv 2002.09405; deepmind-research ``learning_to_simulate``,
``graph_network.py``'s ``EncodeProcessDecode``), on the N-body data, and of
its training step.  It imports nothing of the program.

Parameters are a flat dict in the Flax layout (``layer_0/edge_mlp/Dense_0/
kernel`` is (in, out)); every product goes through
:func:`perfbench.reference.gnn.dense` in precision ``prec`` (``float32``,
``tf32``, ``bfloat16``, ``int8``).  The published equations, written out:

- node input [normalised velocity, mass feature] (x[..., 3:7]); edge input
  [pos[sender] - pos[receiver], its norm];
- MLP: Dense, ReLU, Dense, ReLU, Dense (``n_hidden`` hidden layers), then
  LayerNorm (fast variance, eps 1e-6) on all but the decoder;
- encoder MLP+LN on nodes and edges; each of the unshared steps
  e' = MLP+LN([e, v[sender], v[receiver]]) with the 3L-wide input
  concatenated, agg = the sum of e' at the receivers (sorted by receiver,
  then summed segment by segment), v' = MLP+LN([v, agg]), e += e', v += v';
- output x[..., :6] + decoder(v), the decoder's last product in float32.

Departures from the paper (the configuration's ``assumed`` lists them): a
k-NN graph (k=40) instead of a connectivity radius; the current velocity
and mass instead of a 5-step velocity history and a particle-type
embedding; a 6-wide state delta under the port's physics loss instead of
an acceleration under MSE; the port's Gaussian input noise instead of a
random walk; AdamW with weight decay 0 and a global-norm clip of 1.0.
"""

from typing import Dict

import torch

from perfbench.reference import train as ref_train
from perfbench.reference.gnn import dense, gather, layer_norm

NODE_IN = 4
EDGE_IN = 4


def mlp(params, name: str, x, prec: str, n_dense: int,
        norm: bool = True, last_prec=None) -> torch.Tensor:
    """Dense_0, then ReLU and Dense_i for i < n_dense (the last in
    ``last_prec`` where given), then LayerNorm_0 where ``norm``; float32
    out."""
    y = x
    for i in range(n_dense):
        if i:
            y = torch.relu(y)
        p = last_prec if (last_prec and i == n_dense - 1) else prec
        y = dense(y, params[f"{name}/Dense_{i}/kernel"],
                  params[f"{name}/Dense_{i}/bias"], p).float()
    if norm:
        y = layer_norm(y, params[f"{name}/LayerNorm_0/scale"],
                       params[f"{name}/LayerNorm_0/bias"])
    return y


def receiver_sum(values: torch.Tensor, col: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Sum (G, E, F) edge values at their receivers ``col`` (G, E):
    the edges sorted by receiver, laid into an (n, most edges a receiver)
    table and summed along it."""
    g, e, _ = values.shape
    order = torch.argsort(col, dim=-1, stable=True)
    to = torch.gather(col, 1, order)
    counts = torch.zeros(g, n, dtype=torch.long, device=col.device)
    counts.scatter_add_(1, col, torch.ones_like(col))
    start = torch.cumsum(counts, 1) - counts
    slot = torch.arange(e, device=col.device) - torch.gather(start, 1, to)
    table = values.new_zeros(g, n, int(counts.max()), values.shape[-1])
    graph = torch.arange(g, device=col.device).unsqueeze(1).expand(g, e)
    table = table.index_put((graph, to, slot), gather(values, order))
    return table.sum(2)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            pos: torch.Tensor, edge_index: torch.Tensor, steps: int,
            n_hidden: int, prec: str = "float32") -> torch.Tensor:
    """Next state (G, N, 6) of x (G, N, 7) on edges (G, 2, E) or (2, E).
    Float32 products are full float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g, n = x.shape[0], x.shape[1]
    if edge_index.dim() == 2:
        edge_index = edge_index.expand(g, -1, -1)
    row, col = edge_index[:, 0].long(), edge_index[:, 1].long()
    n_dense = n_hidden + 1
    rel = gather(pos, row) - gather(pos, col)
    edge_in = torch.cat(
        [rel, torch.linalg.vector_norm(rel, dim=-1, keepdim=True)], -1)
    v = mlp(params, "node_encoder", x[..., 3:7], prec, n_dense)
    e = mlp(params, "edge_encoder", edge_in, prec, n_dense)
    for i in range(steps):
        pre = f"layer_{i}"
        e_new = mlp(params, f"{pre}/edge_mlp",
                    torch.cat([e, gather(v, row), gather(v, col)], -1),
                    prec, n_dense)
        agg = receiver_sum(e_new, col, n)
        v_new = mlp(params, f"{pre}/node_mlp", torch.cat([v, agg], -1),
                    prec, n_dense)
        e, v = e + e_new, v + v_new
    return x[..., :6] + mlp(params, "decoder", v, prec, n_dense, norm=False,
                            last_prec="float32")


def draw_step(generator: torch.Generator, b: int, n: int, device) -> dict:
    """A training step's random values, drawn as the step draws them: the
    input noise (B, N, 6), and nothing else (GNS has no dropout)."""
    return {"noise": torch.randn((b, n, 6), generator=generator,
                                 device=device)}


def param_shapes(latent: int, hidden: int, n_hidden: int, steps: int,
                 out: int) -> Dict[str, tuple]:
    """Every parameter by its Flax name, in (in, out) layout."""
    shapes: Dict[str, tuple] = {}

    def add(name, i, o, norm=True):
        widths = [i] + [hidden] * n_hidden + [o]
        for j in range(len(widths) - 1):
            shapes[f"{name}/Dense_{j}/kernel"] = (widths[j], widths[j + 1])
            shapes[f"{name}/Dense_{j}/bias"] = (widths[j + 1],)
        if norm:
            shapes[f"{name}/LayerNorm_0/scale"] = (o,)
            shapes[f"{name}/LayerNorm_0/bias"] = (o,)

    add("node_encoder", NODE_IN, latent)
    add("edge_encoder", EDGE_IN, latent)
    for i in range(steps):
        add(f"layer_{i}/edge_mlp", 3 * latent, latent)
        add(f"layer_{i}/node_mlp", 2 * latent, latent)
    add("decoder", latent, out, norm=False)
    return shapes


def shapes_of(mc: dict) -> Dict[str, tuple]:
    """:func:`param_shapes` of a ``model_config``."""
    return param_shapes(mc["latent_size"], mc["mlp_hidden_size"],
                        mc["mlp_num_hidden_layers"],
                        mc["num_message_passing_steps"], mc["output_dim"])


class ReferenceTrainer(ref_train.ReferenceTrainer):
    """:class:`perfbench.reference.train.ReferenceTrainer` (the physics
    loss, the clip, AdamW) with GNS in the model's place: ``chunk``
    graphs a forward, draws from :func:`draw_step`."""

    def __init__(self, params, state_mean, state_std, masses, edge_index,
                 mc: dict, noise_std: float, lr: float, weight_decay: float,
                 prec: str, chunk: int):
        super().__init__(params, state_mean, state_std, masses, edge_index,
                         mc["num_message_passing_steps"], 0.0, noise_std, lr,
                         weight_decay, prec, chunk)
        self.n_hidden = mc["mlp_num_hidden_layers"]

    def loss_and_grads(self, states, targets, draws) -> float:
        for t in self.params.values():
            t.grad = None
        b = states.shape[0]
        total = 0.0
        mass_feat = (self.masses / self.masses.mean()).view(1, -1, 1)
        for lo in range(0, b, self.chunk):
            hi = min(b, lo + self.chunk)
            s = (states[lo:hi] - self.mean) / self.std
            t = (targets[lo:hi] - self.mean) / self.std
            s = s + self.noise_std * draws["noise"][lo:hi]
            x = torch.cat([s, mass_feat.expand(hi - lo, -1, 1)], -1)
            pred = forward(self.params, x, s[..., :3], self.edge_index,
                           self.n_layers, self.n_hidden, self.prec)
            loss = ref_train.physics_loss(pred, t, self.masses).sum() / b
            loss.backward()
            total += float(loss.detach())
        return total
