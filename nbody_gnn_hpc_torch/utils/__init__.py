"""Host-side utilities: accuracy metrics, stage timers and trace hooks."""

from nbody_gnn_hpc_torch.utils.metrics import (compute_all_metrics,
                                               compute_energy_error,
                                               compute_mae,
                                               compute_momentum_error,
                                               compute_rmse,
                                               compute_trajectory_divergence,
                                               format_metrics_report)
from nbody_gnn_hpc_torch.utils.profiling import (StageTimer, annotate,
                                                 device_trace)

__all__ = ["StageTimer", "annotate", "compute_all_metrics",
           "compute_energy_error", "compute_mae", "compute_momentum_error", "compute_rmse",
           "compute_trajectory_divergence", "device_trace",
           "format_metrics_report"]
