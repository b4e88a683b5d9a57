"""Host-side utilities: accuracy metrics and stage timers."""

from nbody_gnn_hpc_torch.utils.metrics import (compute_all_metrics,
                                               compute_energy_error,
                                               compute_mae,
                                               compute_momentum_error,
                                               compute_rmse,
                                               compute_trajectory_divergence,
                                               format_metrics_report)
from nbody_gnn_hpc_torch.utils.profiling import StageTimer

__all__ = ["StageTimer", "compute_all_metrics", "compute_energy_error",
           "compute_mae", "compute_momentum_error", "compute_rmse",
           "compute_trajectory_divergence", "format_metrics_report"]
