"""Ensemble simulation (the datagen hot path)."""

from nbody_gnn_hpc_torch.parallel.datagen import (build_ensemble_state,
                                                  fetch_host_trajectory,
                                                  simulate_ensemble,
                                                  trajectory_slice)

__all__ = ["build_ensemble_state", "fetch_host_trajectory",
           "simulate_ensemble", "trajectory_slice"]
