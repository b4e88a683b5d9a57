"""Graph ops, the fused edge-stream and whole-layer kernels, the receiver
sum, the direct-force kernels and the card's rate probes."""

import contextlib
import json
from typing import Dict

from nbody_gnn_hpc_torch.ops.edge_sum import (receiver_gather, receiver_sum,
                                              receiver_sum_plain)
from nbody_gnn_hpc_torch.ops.edges import aggregate_to_targets, edge_features
from nbody_gnn_hpc_torch.ops.fused_edge import (
    SourceCSR, TargetCSR, arrival_counters, arrivals_from, dropout_keep,
    fused_edge_backward, fused_edge_backward_reference, fused_edge_layer,
    fused_edge_layer_plain, fused_edge_layer_reference, source_csr,
    target_csr)
from nbody_gnn_hpc_torch.ops.fused_edge_full import (
    fused_full_layer, fused_full_layer_backward_reference,
    fused_full_layer_plain, fused_full_layer_reference)
from nbody_gnn_hpc_torch.ops.knn import (KNN_BLOCK, KNN_DENSE_MAX,
                                         edge_index_for,
                                         fully_connected_edge_index,
                                         is_row_regular, knn_edge_index)
from nbody_gnn_hpc_torch.ops.pairwise import (
    SMALL_MAX_N, accelerations_small, accelerations_small_reference,
    accelerations_symmetric, accelerations_symmetric_mxu,
    accelerations_symmetric_mxu_reference, accelerations_symmetric_reference,
    accelerations_tiled, accelerations_tiled_reference, mma_schedule,
    small_schedule, sym_schedule, tiled_schedule)
from nbody_gnn_hpc_torch.ops.probes import (fma_probe, fma_probe_reference,
                                            rsqrt_probe,
                                            rsqrt_probe_reference)

# What each command prints last: the kernels it launched, so that a caller
# that ran it as a process (the pipeline, chip_smoke.py) can read them.
LAUNCH_LINE = "Kernel launches: "


# Each counter of :func:`launch_counts`: the wrapper that holds it and the
# attribute it is kept in.
_COUNTERS = {
    "fused_edge_fwd": (fused_edge_layer, "launches"),
    "fused_edge_bwd": (fused_edge_backward, "launches"),
    "fused_edge_fwd_bf16": (fused_edge_layer, "bf16_launches"),
    "fused_edge_bwd_bf16": (fused_edge_backward, "bf16_launches"),
    "pairwise_tiled": (accelerations_tiled, "launches"),
    "pairwise_small": (accelerations_small, "launches"),
    "pairwise_symmetric": (accelerations_symmetric, "launches"),
    "fused_full_fwd": (fused_full_layer, "launches"),
    "fused_full_fwd_bf16": (fused_full_layer, "bf16_launches"),
    "pairwise_symmetric_mxu": (accelerations_symmetric_mxu, "launches"),
    "probe_fma": (fma_probe, "launches"),
    "probe_rsqrt": (rsqrt_probe, "launches"),
    "edge_sum": (receiver_sum, "launches")}


def launch_counts() -> Dict[str, int]:
    """Launches of each hand-written kernel in this process so far, by its
    name in the kernel table (each wrapper counts its own; the bf16 forms
    of kernels 1, 2 and 7 apart from their float32 ones; the replays of a
    captured CUDA graph as :class:`CapturedLaunches` credits them)."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


class CapturedLaunches:
    """The launches a CUDA graph's capture counted, credited again at each
    later replay.

    A capture runs the wrappers' Python once, so the counters rise by the
    graph's launches once, and the replay that follows the capture is
    that rise; a replay runs no Python, so :meth:`replayed` adds the rise
    again.  Every launch the device runs is then counted once, whether its
    step ran eagerly, was captured, or was replayed.
    """

    def __init__(self):
        self.rise: Dict[str, int] = {}

    @contextlib.contextmanager
    def capturing(self):
        """Record the counters' rise over the ``with`` block."""
        before = launch_counts()
        yield
        after = launch_counts()
        self.rise = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    def replayed(self) -> None:
        """Count one replay's launches."""
        for name, n in self.rise.items():
            fn, attr = _COUNTERS[name]
            setattr(fn, attr, getattr(fn, attr) + n)


def launch_line() -> str:
    """``LAUNCH_LINE`` and :func:`launch_counts` as one JSON object."""
    return LAUNCH_LINE + json.dumps(launch_counts())


def read_launch_line(output: str) -> Dict[str, int]:
    """The counts of the one :func:`launch_line` in a command's output;
    ``ValueError`` if it holds none or several."""
    lines = [line for line in output.splitlines()
             if line.startswith(LAUNCH_LINE)]
    if len(lines) != 1:
        raise ValueError(f"{len(lines)} kernel launch lines in the output, "
                         f"expected one")
    return json.loads(lines[0][len(LAUNCH_LINE):])


__all__ = ["CapturedLaunches", "LAUNCH_LINE", "KNN_BLOCK", "KNN_DENSE_MAX",
           "SMALL_MAX_N", "SourceCSR",
           "TargetCSR", "accelerations_small", "aggregate_to_targets",
           "arrival_counters", "arrivals_from",
           "accelerations_small_reference", "accelerations_symmetric",
           "accelerations_symmetric_mxu",
           "accelerations_symmetric_mxu_reference",
           "accelerations_symmetric_reference", "accelerations_tiled",
           "accelerations_tiled_reference", "dropout_keep", "edge_features",
           "edge_index_for", "fma_probe", "fma_probe_reference",
           "fully_connected_edge_index",
           "fused_edge_backward", "fused_edge_backward_reference",
           "fused_edge_layer", "fused_edge_layer_plain",
           "fused_edge_layer_reference", "fused_full_layer",
           "fused_full_layer_backward_reference", "fused_full_layer_plain",
           "fused_full_layer_reference",
           "is_row_regular", "knn_edge_index", "launch_counts",
           "launch_line", "mma_schedule", "read_launch_line",
           "receiver_gather", "receiver_sum", "receiver_sum_plain",
           "rsqrt_probe", "rsqrt_probe_reference", "small_schedule",
           "source_csr", "sym_schedule", "target_csr"]
