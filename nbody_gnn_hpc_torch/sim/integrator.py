"""KDK leapfrog integration (port of
``nbody_gnn_hpc_tpu/sim/integrator.py``).

The JAX package compiles a trajectory into one ``lax.scan``; here it is a
Python loop on the device, with the same save cadence and unsaved tail.
"""

from typing import Callable, NamedTuple

import torch

from nbody_gnn_hpc_torch.sim.forces import SOFTENING, accelerations
from nbody_gnn_hpc_torch.sim.state import SimState


class Trajectory(NamedTuple):
    """Saved states, arrays leading with the save axis ``(n_saves, ...)``
    (the reference datagen worker's per-sim dict,
    ``generate_data.py:51-58``)."""

    positions: torch.Tensor      # (n_saves, N, 3)
    velocities: torch.Tensor     # (n_saves, N, 3)
    accelerations: torch.Tensor  # (n_saves, N, 3)
    masses: torch.Tensor         # (N,)
    times: torch.Tensor          # (n_saves,)
    steps: torch.Tensor          # (n_saves,)
    # State after ALL n_steps, including the trailing partial save interval
    # that is integrated but not saved (reference nbody.py:237-241).
    final: SimState = None

    @property
    def n_steps(self) -> int:
        """Number of saved states (the reference's ``n_steps`` key)."""
        return self.positions.shape[0]


def leapfrog_step(state: SimState, dt: float,
                  accel_fn: Callable = accelerations,
                  softening: float = SOFTENING) -> SimState:
    """One KDK step (``nbody.py:202-218``):
    v += dt/2 a;  x += dt v;  a = F(x)/m;  v += dt/2 a."""
    # A Python float enters each op as a scalar in the tensors' dtype, as
    # the JAX package's f32 ``dt`` does (0.5 * dt is exact either way).
    dt = float(dt)
    v_half = state.velocities + 0.5 * dt * state.accelerations
    x_new = state.positions + dt * v_half
    a_new = accel_fn(x_new, state.masses, softening)
    v_new = v_half + 0.5 * dt * a_new
    return SimState(positions=x_new, velocities=v_new, accelerations=a_new,
                    masses=state.masses, time=state.time + dt,
                    step=state.step + 1)


@torch.inference_mode()
def rollout_steps(state: SimState, dt, n_steps: int,
                  softening: float = SOFTENING) -> SimState:
    """Advance ``n_steps`` without saving intermediates."""
    for _ in range(n_steps):
        state = leapfrog_step(state, dt, softening=softening)
    return state


@torch.inference_mode()
def run_trajectory(state: SimState, dt, n_steps: int,
                   save_interval: int = 1,
                   softening: float = SOFTENING) -> Trajectory:
    """Run ``n_steps`` steps, saving the initial state and then every state
    whose 1-based step index is a multiple of ``save_interval``
    (``nbody.py:232-241``): n_saves = 1 + n_steps // save_interval.  The
    trailing ``n_steps % save_interval`` steps are integrated but not
    saved; ``Trajectory.final`` is the fully advanced state."""
    saves = [state]
    for _ in range(n_steps // save_interval):
        state = rollout_steps(state, dt, save_interval, softening)
        saves.append(state)
    final = rollout_steps(state, dt, n_steps % save_interval, softening)
    stack = lambda field: torch.stack(  # noqa: E731
        [getattr(s, field) for s in saves])
    return Trajectory(positions=stack("positions"),
                      velocities=stack("velocities"),
                      accelerations=stack("accelerations"),
                      masses=state.masses, times=stack("time"),
                      steps=stack("step"), final=final)
