"""Host-side utilities: accuracy metrics, stage timers, trace hooks, the
stall watchdog, the HTML trajectory viewer and (imported on first use, as
it needs matplotlib) the ``Visualizer``."""

from nbody_gnn_hpc_torch.utils.html_viewer import export_interactive_html
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
           "export_interactive_html", "format_metrics_report",
           "maybe_watchdog"]


def __getattr__(name):
    # Lazy: the Visualizer brings matplotlib, which the compute path must
    # not depend on.
    if name == "Visualizer":
        from nbody_gnn_hpc_torch.utils.visualization import Visualizer

        return Visualizer
    raise AttributeError(name)
