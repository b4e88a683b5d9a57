"""Simulation state (port of ``nbody_gnn_hpc_tpu/sim/state.py``).

Field names match the reference's ``get_state()`` keys
(``src/hpc/nbody.py:250-259``).
"""

from typing import NamedTuple

import numpy as np
import torch

from nbody_gnn_hpc_torch.device import resolve_device


class SimState(NamedTuple):
    """State of one system (positions/velocities/accelerations (N, 3),
    masses (N,), time/step scalars) or of B systems (a leading B axis on
    every field, time/step of shape (B,))."""

    positions: torch.Tensor
    velocities: torch.Tensor
    accelerations: torch.Tensor
    masses: torch.Tensor
    time: torch.Tensor
    step: torch.Tensor

    @property
    def n_particles(self) -> int:
        return self.positions.shape[-2]

    def to_dict(self) -> dict:
        """Host-side dict with the reference's ``get_state()`` keys."""
        return {
            "positions": self.positions.cpu().numpy(),
            "velocities": self.velocities.cpu().numpy(),
            "accelerations": self.accelerations.cpu().numpy(),
            "masses": self.masses.cpu().numpy(),
            "time": float(self.time),
            "step": int(self.step),
        }


def make_state(positions, velocities, masses, accelerations=None, time=0.0,
               step=0, device=None, dtype=torch.float32) -> SimState:
    """SimState on ``resolve_device(device)``; accelerations default to
    zeros (callers normally recompute them right after)."""
    dev = resolve_device(device)
    as_dev = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a) if not torch.is_tensor(a) else a, dtype=dtype,
        device=dev)
    positions = as_dev(positions)
    velocities = as_dev(velocities)
    masses = as_dev(masses)
    accelerations = (torch.zeros_like(positions) if accelerations is None
                     else as_dev(accelerations))
    batch_shape = positions.shape[:-2]
    return SimState(
        positions=positions, velocities=velocities,
        accelerations=accelerations, masses=masses,
        time=torch.full(batch_shape, float(time), dtype=dtype, device=dev),
        step=torch.full(batch_shape, int(step), dtype=torch.int32,
                        device=dev))
