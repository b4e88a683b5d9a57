"""Graph ops, the fused edge-stream and whole-layer kernels, the
direct-force kernels and the card's rate probes."""

import json
from typing import Dict

from nbody_gnn_hpc_torch.ops.edges import aggregate_to_targets, edge_features
from nbody_gnn_hpc_torch.ops.fused_edge import (
    SourceCSR, TargetCSR, dropout_keep, fused_edge_backward,
    fused_edge_backward_reference, fused_edge_layer, fused_edge_layer_plain,
    fused_edge_layer_reference, source_csr, target_csr)
from nbody_gnn_hpc_torch.ops.fused_edge_full import (
    fused_full_layer, fused_full_layer_plain, fused_full_layer_reference)
from nbody_gnn_hpc_torch.ops.knn import (KNN_BLOCK, KNN_DENSE_MAX,
                                         edge_index_for,
                                         fully_connected_edge_index,
                                         is_row_regular, knn_edge_index)
from nbody_gnn_hpc_torch.ops.pairwise import (
    SMALL_MAX_N, accelerations_small, accelerations_small_reference,
    accelerations_symmetric, accelerations_symmetric_mxu,
    accelerations_symmetric_mxu_reference, accelerations_symmetric_reference,
    accelerations_tiled, accelerations_tiled_reference, small_schedule,
    sym_schedule)
from nbody_gnn_hpc_torch.ops.probes import (fma_probe, fma_probe_reference,
                                            rsqrt_probe,
                                            rsqrt_probe_reference)

# What each command prints last: the kernels it launched, so that a caller
# that ran it as a process (the pipeline, chip_smoke.py) can read them.
LAUNCH_LINE = "Kernel launches: "


def launch_counts() -> Dict[str, int]:
    """Launches of each hand-written kernel in this process so far, by its
    name in the kernel table (each wrapper counts its own)."""
    return {"fused_edge_fwd": fused_edge_layer.launches,
            "fused_edge_bwd": fused_edge_backward.launches,
            "pairwise_tiled": accelerations_tiled.launches,
            "pairwise_small": accelerations_small.launches,
            "pairwise_symmetric": accelerations_symmetric.launches,
            "fused_full_fwd": fused_full_layer.launches,
            "pairwise_symmetric_mxu": accelerations_symmetric_mxu.launches,
            "probe_fma": fma_probe.launches,
            "probe_rsqrt": rsqrt_probe.launches}


def launch_line() -> str:
    """``LAUNCH_LINE`` and :func:`launch_counts` as one JSON object."""
    return LAUNCH_LINE + json.dumps(launch_counts())


__all__ = ["LAUNCH_LINE", "KNN_BLOCK", "KNN_DENSE_MAX", "SMALL_MAX_N",
           "SourceCSR",
           "TargetCSR", "accelerations_small", "aggregate_to_targets",
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
           "fused_full_layer_plain", "fused_full_layer_reference",
           "is_row_regular", "knn_edge_index", "launch_counts",
           "launch_line", "rsqrt_probe",
           "rsqrt_probe_reference", "small_schedule", "source_csr",
           "sym_schedule", "target_csr"]
