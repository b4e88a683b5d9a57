"""The training step (port of ``nbody_gnn_hpc_tpu/train/steps.py``):
normalise -> input noise with the pos resync -> mass-feature concat ->
dropout forward over the batch -> physics loss -> global-norm clip ->
AdamW (reference ``train.py:396-435``).

The batch is one (B, N, 7) forward through the edge kernels' batch axis
(the JAX package vmaps the per-graph forward).  The optimizer is
``torch.optim.AdamW`` with optax's defaults (betas 0.9/0.999, eps 1e-8,
decoupled weight decay on every parameter, as ``optax.adamw`` with no
mask); the clip is written as ``optax.clip_by_global_norm`` writes it.
"""

from typing import Callable, Optional

import torch

from nbody_gnn_hpc_torch.ops.knn import is_row_regular
from nbody_gnn_hpc_torch.train.loss import PhysicsInformedLoss, mse_loss

GRAD_CLIP_NORM = 1.0  # reference train.py:429


def make_optimizer(model: torch.nn.Module, learning_rate: float,
                   weight_decay: float) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=wd)`` over every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """In place, as optax: g if ||g|| < max_norm else g / ||g|| * max_norm.
    Returns the global norm (a device tensor; nothing syncs)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, torch.ones_like(norm), norm))
    torch._foreach_mul_(grads, torch.where(keep, torch.ones_like(norm),
                                           torch.full_like(norm, max_norm)))
    return norm


def make_train_step(model, optimizer: torch.optim.Optimizer, edge_index,
                    state_mean, state_std, mass_feat,
                    noise_std: float = 0.003,
                    masses: Optional[torch.Tensor] = None,
                    criterion: Optional[PhysicsInformedLoss] = None,
                    use_physics_loss: bool = True,
                    schedule: Optional[Callable[[int], float]] = None):
    """Build ``step(states, targets, generator) -> loss`` over RAW
    (unnormalised) (B, N, 6) batches on the model's device.

    ``step`` updates the model and optimizer in place and returns the
    batch loss as a device tensor.  ``step.count`` is the number of updates
    so far; the LR of update ``count`` is ``schedule(count)`` (the base LR
    first, as optax counts).  ``step.compute_loss(states, targets,
    generator=None, deterministic=False)`` gives (total, details) for one
    batch, for training and validation alike.
    """
    if criterion is None and use_physics_loss:
        criterion = PhysicsInformedLoss()
    n_nodes = int(mass_feat.reshape(-1).shape[0])
    if not is_row_regular(edge_index, n_nodes):
        raise ValueError(
            "edge_index is not row-regular (row != repeat(arange(N), k)); "
            "build edges with ops/knn.py")
    dev = next(model.parameters()).device
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    edge_index = as_dev(edge_index).long()
    mean, std = as_dev(state_mean).float(), as_dev(state_std).float()
    mass_feat = as_dev(mass_feat).float().reshape(n_nodes, 1)
    if masses is not None:
        masses = as_dev(masses).float()
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def compute_loss(states, targets, generator=None, deterministic=False):
        model.train(not deterministic)
        s_norm = (states - mean) / std
        t_norm = (targets - mean) / std
        # Input-noise injection on the 6 state features, pos resynced to the
        # noised positions (train.py:409-415).
        if noise_std > 0 and not deterministic:
            s_norm = s_norm + noise_std * torch.randn(
                s_norm.shape, generator=generator, device=dev)
        pos = s_norm[..., :3]
        x = torch.cat([s_norm, mass_feat.expand(*s_norm.shape[:2], 1)], -1)
        pred = model(x, edge_index, pos, generator=generator)
        if criterion is not None:
            return criterion(pred, t_norm, masses)
        total = mse_loss(pred, t_norm)
        zero = torch.zeros((), dtype=pred.dtype, device=dev)
        return total, {"total": total, "position": zero, "velocity": zero,
                       "energy": zero, "momentum": zero}

    def step(states, targets, generator=None):
        optimizer.zero_grad(set_to_none=True)
        loss, _ = compute_loss(states, targets, generator)
        loss.backward()
        clip_by_global_norm_([p.grad for p in params], GRAD_CLIP_NORM)
        if schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = schedule(step.count)
        optimizer.step()
        step.count += 1
        return loss.detach()

    step.count = 0
    step.compute_loss = compute_loss
    return step
