"""Ensemble simulation on one device (the datagen hot path; port of
``nbody_gnn_hpc_tpu/parallel/datagen.py``).

Initial conditions are built on the host with the reference's exact RNG
streams, stacked into a (B, N, ...) batch, and the whole ensemble is
integrated on the device by :func:`run_trajectory_batch`: every step is one
force evaluation of all B systems, the saved stacks stay on the device, and
:func:`fetch_host_trajectory` reads them back once.

The JAX package's sims-in-lanes layout (``sim/lanes.py``) is a TPU layout
and is not carried over; its contract (arrays lead with the sim axis,
initial state first, unsaved tail in ``.final``) is what
:func:`run_trajectory_batch` returns on the (B, N, 3) layout.
"""

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from nbody_gnn_hpc_torch.device import SOFTENING, resolve_device
from nbody_gnn_hpc_torch.ops.pairwise import SMALL_MAX_N, accelerations_small
from nbody_gnn_hpc_torch.sim.forces import accelerations
from nbody_gnn_hpc_torch.sim.initial_conditions import \
    random_initial_conditions
from nbody_gnn_hpc_torch.sim.integrator import Trajectory, run_trajectory_batch
from nbody_gnn_hpc_torch.sim.state import SimState, make_state


def ensemble_force(device: torch.device, n_particles: int) -> Callable:
    """The batch force :func:`simulate_ensemble` uses on ``device``: on a
    CUDA device with N <= SMALL_MAX_N ``ops.accelerations_small`` (kernel 4,
    one launch for all B systems), else ``sim.accelerations``.  PERF.md
    holds the times of both at the production shape (300 sims x N=200)."""
    if device.type == "cuda" and n_particles <= SMALL_MAX_N:
        return accelerations_small
    return accelerations


def build_ensemble_state(seeds: Sequence[int], n_particles: int,
                         box_size: float,
                         shared_masses: Optional[np.ndarray] = None,
                         device=None,
                         accel_fn: Optional[Callable] = None) -> SimState:
    """Stacked SimState, one sim per seed, with the reference's per-sim
    draws (``generate_data.py:36-47``): ICs from the seed, then the
    shared-mass override and the acceleration recompute."""
    ps, vs, ms = [], [], []
    for seed in seeds:
        p, v, m = random_initial_conditions(n_particles, box_size=box_size,
                                            seed=int(seed))
        ps.append(p)
        vs.append(v)
        ms.append(shared_masses if shared_masses is not None else m)
    state = make_state(np.stack(ps), np.stack(vs), np.stack(ms),
                       device=device)
    if accel_fn is None:
        accel_fn = ensemble_force(state.positions.device, n_particles)
    return state._replace(
        accelerations=accel_fn(state.positions, state.masses))


def simulate_ensemble(seeds: Sequence[int],
                      n_particles: int,
                      n_steps: int,
                      box_size: float = 10.0,
                      dt: float = 0.001,
                      save_interval: int = 1,
                      shared_masses: Optional[np.ndarray] = None,
                      softening: float = SOFTENING,
                      mesh=None,
                      device=None,
                      accel_fn: Optional[Callable] = None) -> Trajectory:
    """Run len(seeds) independent sims as one batch on one device.

    Returns a Trajectory of device tensors that lead with the sim axis:
    positions (B, n_saves, N, 3), masses (B, N), times/steps (B, n_saves).

    ``device``: cuda unless the CPU is asked for.  ``accel_fn``: the force
    of the whole batch, ``f(positions (B, N, 3), masses (B, N), softening)``;
    by default :func:`ensemble_force`'s choice.  ``mesh`` (several devices)
    is not ported yet and raises.  The JAX function's ``layout`` argument
    chooses between TPU layouts and has no counterpart here.
    """
    if mesh is not None:
        raise NotImplementedError(
            "simulate_ensemble over a device mesh is not ported yet; it "
            "runs on one device")
    dev = resolve_device(device)
    if accel_fn is None:
        accel_fn = ensemble_force(dev, n_particles)
    state = build_ensemble_state(seeds, n_particles, box_size, shared_masses,
                                 device=dev, accel_fn=accel_fn)
    return run_trajectory_batch(state, dt, n_steps, save_interval, softening,
                                accel_fn=accel_fn)


def _map_tensors(fn: Callable, traj: Trajectory) -> Trajectory:
    final = None if traj.final is None else SimState(*map(fn, traj.final))
    return Trajectory(*map(fn, traj[:6]), final=final)


def fetch_host_trajectory(traj: Trajectory) -> Trajectory:
    """The ensemble Trajectory as NumPy arrays (one readback per field)."""
    return _map_tensors(lambda t: t.cpu().numpy(), traj)


def trajectory_slice(traj: Trajectory, i: int) -> Trajectory:
    """Per-sim view of an ensemble Trajectory (for persistence)."""
    return _map_tensors(lambda x: x[i], traj)
