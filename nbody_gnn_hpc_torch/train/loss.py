"""Physics-informed loss (port of ``nbody_gnn_hpc_tpu/train/loss.py``).

    total = 1.0*MSE(pos) + 1.0*MSE(vel)
          + 0.1*MSE(per-graph sum KE) + 0.1*MSE(per-graph sum momentum)

with masses renormalised by their mean inside the loss (reference
``src/ai/train.py:231-236``), over dense (B, N, 6) batches.
"""

from typing import Dict, Optional, Tuple

import torch


class PhysicsInformedLoss:
    """Callable loss; returns (total, details) with the reference's keys
    total/position/velocity/energy/momentum (0-dim tensors)."""

    def __init__(self,
                 position_weight: float = 1.0,
                 velocity_weight: float = 1.0,
                 energy_weight: float = 0.1,
                 momentum_weight: float = 0.1):
        self.position_weight = position_weight
        self.velocity_weight = velocity_weight
        self.energy_weight = energy_weight
        self.momentum_weight = momentum_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 masses: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Args:
            pred/target: (B, N, 6) [pos(3), vel(3)] in normalised space.
            masses: (N,) particle masses shared by the batch.
        """
        pred_pos, pred_vel = pred[..., :3], pred[..., 3:6]
        tgt_pos, tgt_vel = target[..., :3], target[..., 3:6]

        pos_loss = torch.mean((pred_pos - tgt_pos) ** 2)
        vel_loss = torch.mean((pred_vel - tgt_vel) ** 2)

        zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
        energy_loss = momentum_loss = zero

        if masses is not None:
            mass_scale = masses.mean()
            norm_m = torch.where(mass_scale > 0, masses / mass_scale, masses)

            if self.momentum_weight > 0:
                # Per-graph total momentum: (B, 3).
                pred_mom = torch.sum(norm_m[None, :, None] * pred_vel, dim=1)
                tgt_mom = torch.sum(norm_m[None, :, None] * tgt_vel, dim=1)
                momentum_loss = torch.mean((pred_mom - tgt_mom) ** 2)

            if self.energy_weight > 0:
                # Per-graph total kinetic energy: (B,).
                pred_ke = torch.sum(
                    0.5 * norm_m[None, :] * torch.sum(pred_vel ** 2, -1), 1)
                tgt_ke = torch.sum(
                    0.5 * norm_m[None, :] * torch.sum(tgt_vel ** 2, -1), 1)
                energy_loss = torch.mean((pred_ke - tgt_ke) ** 2)

        total = (self.position_weight * pos_loss
                 + self.velocity_weight * vel_loss
                 + self.energy_weight * energy_loss
                 + self.momentum_weight * momentum_loss)

        return total, {
            "total": total,
            "position": pos_loss,
            "velocity": vel_loss,
            "energy": energy_loss,
            "momentum": momentum_loss,
        }


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain MSE alternative (the reference's non-physics branch)."""
    return torch.mean((pred - target) ** 2)
