"""Exact N-body simulation: forces, state, KDK leapfrog, energy
diagnostics and the float64 reference oracle."""

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
from nbody_gnn_hpc_torch.sim.reference_f64 import (accelerations_f64,
                                                   protocol_ground_truth,
                                                   simulate_f64,
                                                   total_energy_f64)
from nbody_gnn_hpc_torch.sim.state import SimState, make_state

__all__ = ["PALLAS_MIN_N", "SimState", "Trajectory", "accelerations",
           "accelerations_f64", "blocked_accelerations", "kinetic_energy",
           "leapfrog_step", "make_state", "pairwise_accelerations",
           "potential_energy", "protocol_ground_truth",
           "random_initial_conditions", "rollout_steps", "run_trajectory",
           "run_trajectory_batch", "shared_masses", "simulate_f64",
           "total_energy", "total_energy_f64", "total_momentum"]
