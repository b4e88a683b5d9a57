"""Graph ops, the fused edge-stream and whole-layer kernels, the
direct-force kernels and the card's rate probes."""

from nbody_gnn_hpc_torch.ops.edges import edge_features
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
    accelerations_tiled, accelerations_tiled_reference)
from nbody_gnn_hpc_torch.ops.probes import (fma_probe, fma_probe_reference,
                                            rsqrt_probe,
                                            rsqrt_probe_reference)

__all__ = ["KNN_BLOCK", "KNN_DENSE_MAX", "SMALL_MAX_N", "SourceCSR",
           "TargetCSR", "accelerations_small",
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
           "is_row_regular", "knn_edge_index", "rsqrt_probe",
           "rsqrt_probe_reference", "source_csr", "target_csr"]
