"""Graph ops and the fused edge-stream kernel."""

from nbody_gnn_hpc_torch.ops.edges import edge_features
from nbody_gnn_hpc_torch.ops.fused_edge import (TargetCSR, fused_edge_layer,
                                                fused_edge_layer_reference,
                                                target_csr)
from nbody_gnn_hpc_torch.ops.knn import (KNN_BLOCK, KNN_DENSE_MAX,
                                         edge_index_for,
                                         fully_connected_edge_index,
                                         is_row_regular, knn_edge_index)

__all__ = ["KNN_BLOCK", "KNN_DENSE_MAX", "TargetCSR", "edge_features",
           "edge_index_for", "fully_connected_edge_index", "fused_edge_layer",
           "fused_edge_layer_reference", "is_row_regular", "knn_edge_index",
           "target_csr"]
