"""Plain reference of the production training step, written from the
recipe: normalise; Gaussian input noise (std ``noise_std``) on the six state
features, the edge features taken from the noised positions; the model with
dropout; the physics loss (1.0 MSE(pos) + 1.0 MSE(vel) + 0.1 MSE(per-graph
kinetic energy) + 0.1 MSE(per-graph momentum), masses over their mean); the
gradient clipped to global norm 1.0 (g * 1/||g|| where ||g|| >= 1); AdamW
(betas 0.9 / 0.999, eps 1e-8, decoupled weight decay, bias-corrected).

The batch runs in chunks of graphs, each chunk's loss weighted by its
share of the batch, so that a large graph fits: every term of the loss is a
mean over the batch's graphs, so the sum of the weighted chunks is the
batch's loss and gradient.
"""

import math
from typing import Dict, List

import torch

from perfbench.reference import gnn

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
CLIP = 1.0


def physics_loss(pred, target, masses):
    """(G,) per-graph losses whose mean over the batch is the loss."""
    mse = lambda a, b: ((a - b) ** 2).mean((-2, -1))  # noqa: E731
    norm_m = masses / masses.mean()
    pv, tv = pred[..., 3:6], target[..., 3:6]
    mom = lambda v: (norm_m[None, :, None] * v).sum(1)  # noqa: E731
    ke = lambda v: (0.5 * norm_m[None, :] * (v ** 2).sum(-1)).sum(1)  # noqa
    return (mse(pred[..., :3], target[..., :3]) + mse(pv, tv)
            + 0.1 * (ke(pv) - ke(tv)) ** 2
            + 0.1 * ((mom(pv) - mom(tv)) ** 2).mean(-1))


class ReferenceTrainer:
    """The reference's parameters and AdamW state, float32 throughout,
    stepped by :meth:`step` on the same batches and draws as the program.

    ``params``: flat Flax-layout tensors (copied); ``chunk``: graphs a
    forward; ``prec``: the products' precision (:data:`gnn.PRECISIONS`).
    """

    def __init__(self, params: Dict[str, torch.Tensor], state_mean,
                 state_std, masses, edge_index, n_layers: int,
                 dropout: float, noise_std: float, lr: float,
                 weight_decay: float, prec: str, chunk: int):
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.mean, self.std = state_mean, state_std
        self.masses, self.edge_index = masses, edge_index
        self.n_layers, self.p, self.noise_std = n_layers, dropout, noise_std
        self.lr, self.wd, self.prec, self.chunk = lr, weight_decay, prec, chunk
        self.count = 0

    def loss_and_grads(self, states, targets, draws) -> float:
        """Batch loss, with each parameter's gradient (unclipped) in
        ``.grad``."""
        for t in self.params.values():
            t.grad = None
        b = states.shape[0]
        total = 0.0
        mass_feat = (self.masses / self.masses.mean()).view(1, -1, 1)
        for lo in range(0, b, self.chunk):
            hi = min(b, lo + self.chunk)
            d = gnn.rows_of(draws, lo, hi)
            s = (states[lo:hi] - self.mean) / self.std
            t = (targets[lo:hi] - self.mean) / self.std
            s = s + self.noise_std * d["noise"]
            x = torch.cat([s, mass_feat.expand(hi - lo, -1, 1)], -1)
            pred = gnn.forward(self.params, x, s[..., :3], self.edge_index,
                               self.n_layers, self.prec, d, self.p, lo)
            per_graph = physics_loss(pred, t, self.masses)
            loss = per_graph.sum() / b
            loss.backward()
            total += float(loss.detach())
        return total

    @torch.no_grad()
    def update(self) -> Dict[str, torch.Tensor]:
        """Clip and AdamW; returns the clipped gradients the optimizer got."""
        grads = {k: p.grad for k, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        factor = 1.0 if float(norm) < CLIP else CLIP / float(norm)
        self.count += 1
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        got = {}
        for k, p in self.params.items():
            g = grads[k] * factor
            got[k] = g
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + ADAM_EPS
            p.sub_(self.lr / bc1 * self.m[k] / denom)
        return got

    def step(self, states, targets, draws) -> tuple:
        """(loss, clipped gradients) of one step."""
        loss = self.loss_and_grads(states, targets, draws)
        return loss, self.update()


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   leaves: List[str]) -> tuple:
    """(gap, leaf): the largest |got - want| over ``leaves``, each against
    the larger of the reference's norm of that leaf and its median leaf's."""
    med = sorted(want[k] for k in leaves)[len(leaves) // 2]
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in leaves}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst
