"""Exact N-body simulation: forces, state, KDK leapfrog."""

from nbody_gnn_hpc_torch.sim.forces import (PALLAS_MIN_N, accelerations,
                                            blocked_accelerations,
                                            pairwise_accelerations)
from nbody_gnn_hpc_torch.sim.initial_conditions import (
    random_initial_conditions, shared_masses)
from nbody_gnn_hpc_torch.sim.integrator import (Trajectory, leapfrog_step,
                                                rollout_steps, run_trajectory)
from nbody_gnn_hpc_torch.sim.state import SimState, make_state

__all__ = ["PALLAS_MIN_N", "SimState", "Trajectory", "accelerations",
           "blocked_accelerations", "leapfrog_step", "make_state",
           "pairwise_accelerations", "random_initial_conditions",
           "rollout_steps", "run_trajectory", "shared_masses"]
