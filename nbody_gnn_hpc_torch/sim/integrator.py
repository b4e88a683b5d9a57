"""KDK leapfrog integration (port of
``nbody_gnn_hpc_tpu/sim/integrator.py``).

The JAX package compiles a trajectory into one ``lax.scan``; here it is a
Python loop on the device, with the same save cadence and unsaved tail.
The saved stacks are allocated once on the device and filled in place, so
a caller pays one readback at the end.
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
                  softening: float = SOFTENING,
                  accel_fn: Callable = accelerations) -> SimState:
    """Advance ``n_steps`` without saving intermediates."""
    for _ in range(n_steps):
        state = leapfrog_step(state, dt, accel_fn, softening)
    return state


def _run(state: SimState, dt, n_steps: int, save_interval: int,
         softening: float, accel_fn: Callable, save_axis: int) -> Trajectory:
    """Integrate and save into stacks preallocated on the state's device,
    the save axis at ``save_axis`` of every saved field."""
    n_saves = 1 + n_steps // save_interval

    def stack_like(t):
        shape = list(t.shape)
        shape.insert(save_axis, n_saves)
        return torch.empty(shape, dtype=t.dtype, device=t.device)

    fields = ("positions", "velocities", "accelerations", "time", "step")
    stacks = [stack_like(getattr(state, f)) for f in fields]
    for k in range(n_saves):
        if k:
            state = rollout_steps(state, dt, save_interval, softening,
                                  accel_fn)
        for stack, f in zip(stacks, fields):
            stack.select(save_axis, k).copy_(getattr(state, f))
    final = rollout_steps(state, dt, n_steps % save_interval, softening,
                          accel_fn)
    return Trajectory(positions=stacks[0], velocities=stacks[1],
                      accelerations=stacks[2], masses=state.masses,
                      times=stacks[3], steps=stacks[4], final=final)


@torch.inference_mode()
def run_trajectory(state: SimState, dt, n_steps: int,
                   save_interval: int = 1,
                   softening: float = SOFTENING) -> Trajectory:
    """Run ``n_steps`` steps, saving the initial state and then every state
    whose 1-based step index is a multiple of ``save_interval``
    (``nbody.py:232-241``): n_saves = 1 + n_steps // save_interval.  The
    trailing ``n_steps % save_interval`` steps are integrated but not
    saved; ``Trajectory.final`` is the fully advanced state.  The save axis
    leads every field."""
    return _run(state, dt, n_steps, save_interval, softening, accelerations,
                save_axis=0)


@torch.inference_mode()
def run_trajectory_batch(state: SimState, dt, n_steps: int,
                         save_interval: int = 1,
                         softening: float = SOFTENING,
                         accel_fn: Callable = accelerations) -> Trajectory:
    """:func:`run_trajectory` of a batched state (B, N, 3), arrays leading
    with the simulation axis as the JAX package's ``run_trajectory_batch``
    and ``run_trajectory_batch_lanes`` return them: positions
    (B, n_saves, N, 3), masses (B, N), times and steps (B, n_saves).
    ``accel_fn`` is the force of the whole batch."""
    if state.positions.dim() != 3:
        raise ValueError("run_trajectory_batch takes a batched state "
                         f"(B, N, 3), got {tuple(state.positions.shape)}")
    return _run(state, dt, n_steps, save_interval, softening, accel_fn,
                save_axis=1)
