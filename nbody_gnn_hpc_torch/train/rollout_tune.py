"""Rollout-aware fine-tuning: a K-step unrolled objective (port of
``nbody_gnn_hpc_tpu/train/rollout_tune.py``).

The one-step physics loss anticorrelates with multi-step rollout quality
(RESULTS.md).  This fine-tunes a trained model by unrolling it K steps as
inference does (normalise -> on-device k-NN -> deterministic forward ->
denormalise -> feed back, ``Predictor._rollout``) and penalising the
normalised-state error at every unrolled step.  The gradient runs through
the whole chain: each prediction is the next step's input, and reaches the
edge features through its positions (kernel 2's ``d_edge_attr``, or kernel
7's backward with ``edge_impl="fused_full"``).

The batch is one batched forward a step with per-graph edges (B, 2, E),
the counterpart of the JAX package's ``vmap``.  Nothing is rematerialised:
the edge kernels' autograd Functions keep only node-sized tensors, the edge
features and the CSR, not the (E, H) edge activations that the JAX package
rematerialises each step to avoid.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nbody_gnn_hpc_torch.device import use_full_f32
from nbody_gnn_hpc_torch.ops.knn import (fully_connected_edge_index,
                                         knn_edge_index)
from nbody_gnn_hpc_torch.train.steps import (GRAD_CLIP_NORM,
                                             clip_by_global_norm_,
                                             make_optimizer)

FINETUNE_WEIGHT_DECAY = 1e-4
N_VAL_WINDOWS = 16


def load_trajectory_tensor(checkpoint_dir, sim_names) -> np.ndarray:
    """(n_sims, n_saves, N, 6) float32 [pos(3), vel(3)] from the saved
    trajectory files (needs h5py)."""
    from nbody_gnn_hpc_torch.io import CheckpointManager

    mgr = CheckpointManager(str(checkpoint_dir))
    seqs = []
    for name in sim_names:
        t = mgr.load_trajectory(name)
        seqs.append(np.concatenate(
            [t["positions"], t["velocities"]], axis=-1).astype(np.float32))
    return np.stack(seqs)


def make_unroll_loss(model, norm_stats: Dict, mass_feat,
                     k_neighbors: Optional[int], n_particles: int,
                     horizon: int):
    """``loss(seq)`` over (B, horizon+1, N, 6) RAW states on the model's
    device: unroll ``horizon`` steps from ``seq[:, 0]``, the MSE in
    normalised space against ``seq[:, 1:]``, averaged over the horizon,
    then over the batch.  The forward is deterministic (``model.eval()``)."""
    dev = next(model.parameters()).device
    mean = torch.as_tensor(np.asarray(norm_stats["state_mean"]),
                           dtype=torch.float32, device=dev)
    std = torch.as_tensor(np.asarray(norm_stats["state_std"]),
                          dtype=torch.float32, device=dev)
    mass_feat = torch.as_tensor(np.asarray(mass_feat), dtype=torch.float32,
                                device=dev).reshape(n_particles, 1)
    use_knn = k_neighbors is not None and k_neighbors < n_particles - 1
    static_edges = None if use_knn else torch.as_tensor(
        fully_connected_edge_index(n_particles), device=dev)

    def one_step(s_raw):
        """One inference-equivalent step in raw units."""
        s_norm = (s_raw - mean) / std
        pos = s_norm[..., :3]
        # The neighbour indices carry no gradient; building them from a
        # detached copy keeps the (B, N, N) distances out of the graph.
        edges = knn_edge_index(pos.detach(), k_neighbors) if use_knn \
            else static_edges
        x = torch.cat([s_norm, mass_feat.expand(*s_norm.shape[:-1], 1)], -1)
        pred_norm = model(x, edges, pos)
        return pred_norm * std + mean, pred_norm

    def loss(seq):
        model.eval()
        tgt_norm = (seq[:, 1:] - mean) / std  # (B, H, N, 6)
        s_raw, errs = seq[:, 0], []
        for t in range(horizon):
            s_raw, pred_norm = one_step(s_raw)
            errs.append(((pred_norm - tgt_norm[:, t]) ** 2).mean((-2, -1)))
        return torch.stack(errs, 1).mean(1).mean()

    return loss


def make_unroll_step(model, loss_fn, optimizer):
    """``step(seq) -> loss``: one optimizer update on the unrolled loss
    (global-norm clip, then AdamW); the loss stays a device tensor."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(seq):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(seq)
        loss.backward()
        clip_by_global_norm_([p.grad for p in params], GRAD_CLIP_NORM)
        optimizer.step()
        return loss.detach()

    return step


def finetune_rollout(model, trajectories: np.ndarray, norm_stats: Dict,
                     masses: np.ndarray, k_neighbors: Optional[int] = 40,
                     horizon: int = 8, batch_size: int = 8,
                     learning_rate: float = 5e-5, n_steps: int = 1000,
                     seed: int = 0, log_every: int = 100,
                     val_fraction: float = 0.1, progress_cb=None
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """Fine-tune ``model`` (on its device) with the K-step unrolled
    objective.

    Args:
        trajectories: (n_sims, n_saves, N, 6) raw state sequences; the last
            ``max(1, int(val_fraction * n_sims))`` are held out.
        horizon: unroll length K.
        n_steps: optimizer steps (a fresh AdamW state on every call).
        progress_cb: optional no-arg callable invoked after each validation
            readback (the initial one and every ``log_every`` steps): a
            stall-watchdog beat hook.

    Returns:
        (best_state_dict, history): a copy of the parameters with the best
        held-out unroll loss, which the model also holds on return, and
        ``{"train_loss": [...], "val_loss": [...]}``.
    """
    n_sims, n_saves, n_particles, _ = trajectories.shape
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        use_full_f32()  # the unroll is precision-sensitive: no TF32
    mass_feat = (masses / masses.mean()).reshape(-1, 1).astype(np.float32)
    loss_fn = make_unroll_loss(model, norm_stats, mass_feat, k_neighbors,
                               n_particles, horizon)
    step = make_unroll_step(model, loss_fn, make_optimizer(
        model, learning_rate, FINETUNE_WEIGHT_DECAY))

    data = torch.as_tensor(np.asarray(trajectories, np.float32), device=dev)
    n_val_sims = max(1, int(val_fraction * n_sims))
    train_sims = n_sims - n_val_sims
    window = torch.arange(horizon + 1, device=dev)

    def windows(sim_idx, t_idx):
        """(B, horizon+1, N, 6) windows gathered on the device."""
        si = torch.as_tensor(sim_idx, device=dev)
        ti = torch.as_tensor(t_idx, device=dev)
        return data[si[:, None], ti[:, None] + window[None, :]]

    def val_loss():
        with torch.no_grad():
            return loss_fn(windows(v_si, v_ti)).item()

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    rng = np.random.RandomState(seed)
    # Fixed held-out probe windows from the validation sims.
    v_si = rng.randint(train_sims, n_sims, N_VAL_WINDOWS)
    v_ti = rng.randint(0, n_saves - horizon - 1, N_VAL_WINDOWS)

    history = {"train_loss": [], "val_loss": []}
    best_state, best_val = snapshot(), val_loss()
    history["val_loss"].append(best_val)
    print(f"  initial unroll-{horizon} val loss: {best_val:.6f}")
    if progress_cb is not None:
        progress_cb()  # the first readback completed

    for it in range(1, n_steps + 1):
        si = rng.randint(0, train_sims, batch_size)
        ti = rng.randint(0, n_saves - horizon - 1, batch_size)
        loss = step(windows(si, ti))
        if it % log_every == 0 or it == n_steps:
            val, train = val_loss(), loss.item()
            history["train_loss"].append(train)
            history["val_loss"].append(val)
            marker = ""
            if val < best_val:
                best_val, best_state = val, snapshot()
                marker = " *BEST"
            print(f"  step {it:5d} | train {train:.6f} | "
                  f"val {val:.6f}{marker}")
            if progress_cb is not None:
                progress_cb()  # this chunk's readbacks completed

    model.load_state_dict(best_state)
    return best_state, history
