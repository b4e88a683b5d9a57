"""Plain reference of a served rollout: the checkpoint read from its file,
its kernels rounded to int8 by the serving rule, and each step as the
protocol defines it: normalise, the k nearest neighbours of every particle
(itself excluded), the model, de-normalise."""

import pickle

import numpy as np
import torch

from perfbench.reference import gnn


class _Unpickler(pickle.Unpickler):
    """Reads the checkpoint's optimizer-state classes, where their library
    is missing, as plain tuples (only the parameters are used)."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (tuple,), {"__new__": lambda c, *a:
                                         tuple.__new__(c, a)})


def load_params(path: str):
    """(flat Flax-layout parameters as float32 numpy, norm stats)."""
    with open(path, "rb") as f:
        ckpt = _Unpickler(f).load()
    flat = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            name = f"{prefix}/{key}" if prefix else key
            if isinstance(val, dict):
                walk(val, name)
            else:
                flat[name] = np.asarray(val, np.float32)

    walk(ckpt["model_state_dict"], "")
    return flat, {k: np.asarray(v, np.float32)
                  for k, v in ckpt["norm_stats"].items()}


def int8_weights(params: dict) -> dict:
    """The serving rule: every kernel (2-D) as int8 with a symmetric scale
    per output channel (its last axis), s = max|w| / 127 over the input
    rows (at least 1e-12), q = round(w / s) clipped to +-127; dequantized.
    Biases and LayerNorm parameters stay float32."""
    out = {}
    for name, w in params.items():
        if w.ndim >= 2:
            scale = np.maximum(np.max(np.abs(w), axis=0) / np.float32(127.0),
                               np.float32(1e-12)).astype(np.float32)
            q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
            w = q.astype(np.float32) * scale
        out[name] = w
    return out


def knn(pos: torch.Tensor, k: int, block: int = 512) -> torch.Tensor:
    """(G, 2, N*k) edges: row i repeated k times, then its k nearest
    neighbours (squared distance, itself excluded), by row blocks."""
    g, n, _ = pos.shape
    ids = torch.arange(n, device=pos.device)
    parts = []
    for s in range(0, n, block):
        q = pos[:, s:s + block]
        d2 = ((q.unsqueeze(-2) - pos.unsqueeze(-3)) ** 2).sum(-1)
        self_hit = ids[s:s + block, None] == ids[None, :]
        d2 = torch.where(self_hit, torch.full_like(d2, float("inf")), d2)
        parts.append(torch.topk(-d2, k, dim=-1).indices)
    col = torch.cat(parts, 1).reshape(g, n * k)
    row = ids.repeat_interleave(k).expand(g, -1)
    return torch.stack([row, col], 1)


@torch.no_grad()
def rollout(params: dict, norm_stats: dict, pos0, vel0, masses,
            n_steps: int, k: int, n_layers: int, prec: str = "float32",
            device="cpu"):
    """Final (G, N, 3) positions and velocities after ``n_steps`` of
    (G, N, 3) states with (G, N) masses (each system's mass feature is its
    masses over their mean)."""
    t = lambda a: torch.as_tensor(np.array(a, np.float32),  # noqa: E731
                                  device=device)
    p = {name: t(w) for name, w in params.items()}
    mean, std = t(norm_stats["state_mean"]), t(norm_stats["state_std"])
    pos, vel, m = t(pos0), t(vel0), t(masses)
    mass_feat = (m / m.mean(-1, keepdim=True)).unsqueeze(-1)
    for _ in range(n_steps):
        npos = (pos - mean[:3]) / std[:3]
        nvel = (vel - mean[3:]) / std[3:]
        x = torch.cat([npos, nvel, mass_feat], -1)
        pred = gnn.forward(p, x, npos, knn(npos, k), n_layers, prec)
        pos = pred[..., :3] * std[:3] + mean[:3]
        vel = pred[..., 3:6] * std[3:6] + mean[3:6]
    return pos, vel
