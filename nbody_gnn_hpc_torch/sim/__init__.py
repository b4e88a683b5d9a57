"""Exact N-body simulation: forces, state, KDK leapfrog, energy
diagnostics, the float64 reference oracle and the reference's simulator
surface (``NBodySimulator``, ``run_parallel_simulations``)."""

import numpy as np
import torch

from nbody_gnn_hpc_torch.device import G, SOFTENING, resolve_device
from nbody_gnn_hpc_torch.sim.energy import (kinetic_energy, potential_energy,
                                            total_energy, total_momentum)
from nbody_gnn_hpc_torch.sim.forces import (PALLAS_MIN_N, accelerations,
                                            blocked_accelerations,
                                            pairwise_accelerations)
from nbody_gnn_hpc_torch.sim.initial_conditions import (
    random_initial_conditions, shared_masses)
from nbody_gnn_hpc_torch.sim.integrator import (Trajectory, leapfrog_step,
                                                rollout_steps, run_trajectory,
                                                run_trajectory_batch)
from nbody_gnn_hpc_torch.sim.reference_f64 import (TrajectoryF64,
                                                   accelerations_f64,
                                                   measure_numpy_baseline,
                                                   protocol_ground_truth,
                                                   simulate_f64,
                                                   total_energy_f64)
from nbody_gnn_hpc_torch.sim.simulator import (NBodySimulator,
                                               run_parallel_simulations,
                                               trajectory_to_states)
from nbody_gnn_hpc_torch.sim.state import SimState, make_state


def _tensor(a, device):
    return a if torch.is_tensor(a) else torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=resolve_device(device))


def compute_accelerations_direct(positions, masses, softening=SOFTENING,
                                 device=None):
    """Reference-named alias (``src/hpc/nbody.py:22-66``) of the
    dispatching force :func:`accelerations`: a tensor in, a tensor out on
    its device; NumPy in, NumPy out, computed on ``device`` (cuda unless
    the CPU is asked for)."""
    out = accelerations(_tensor(positions, device), _tensor(masses, device),
                        softening)
    return out if torch.is_tensor(positions) else out.cpu().numpy()


def compute_total_energy(positions, velocities, masses, softening=SOFTENING,
                         device=None):
    """Reference-named alias (``src/hpc/nbody.py:101-130``): (kinetic,
    potential, total) as floats, from NumPy arrays (on ``device``) or
    tensors."""
    ke, pe, te = total_energy(_tensor(positions, device),
                              _tensor(velocities, device),
                              _tensor(masses, device), softening)
    return float(ke), float(pe), float(te)

__all__ = ["G", "PALLAS_MIN_N", "SOFTENING", "NBodySimulator", "SimState",
           "Trajectory", "TrajectoryF64", "accelerations",
           "accelerations_f64", "blocked_accelerations",
           "compute_accelerations_direct", "compute_total_energy",
           "kinetic_energy", "leapfrog_step", "make_state",
           "measure_numpy_baseline", "pairwise_accelerations",
           "potential_energy", "protocol_ground_truth",
           "random_initial_conditions", "rollout_steps", "run_trajectory",
           "run_parallel_simulations", "run_trajectory_batch",
           "shared_masses", "simulate_f64", "total_energy",
           "total_energy_f64", "total_momentum", "trajectory_to_states"]
