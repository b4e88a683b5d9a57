"""Host-side utilities: accuracy metrics, stage timers, trace hooks and the
stall watchdog."""

from nbody_gnn_hpc_torch.utils.metrics import (compute_all_metrics,
                                               compute_energy_error,
                                               compute_mae,
                                               compute_momentum_error,
                                               compute_rmse,
                                               compute_trajectory_divergence,
                                               format_metrics_report)
from nbody_gnn_hpc_torch.utils.profiling import (StageTimer, annotate,
                                                 device_trace)
from nbody_gnn_hpc_torch.utils.watchdog import (STALL_EXIT_CODE, Watchdog,
                                                maybe_watchdog)

__all__ = ["STALL_EXIT_CODE", "StageTimer", "Watchdog", "annotate",
           "compute_all_metrics", "compute_energy_error", "compute_mae",
           "compute_momentum_error", "compute_rmse",
           "compute_trajectory_divergence", "device_trace",
           "format_metrics_report", "maybe_watchdog"]
