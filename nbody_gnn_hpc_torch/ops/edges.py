"""Physics-informed edge features (port of ``nbody_gnn_hpc_tpu/ops/edges.py``).

Numerics match the reference ``NBodyGNN.compute_edge_features``
(``src/ai/model.py:124-132``): dist = |pos_col - pos_row| + 1e-8;
direction = diff / dist; inv_dist_sq = 1 / (dist^2 + 1e-6).
"""

import torch


def gather_nodes(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[..., index, :]`` per graph: x (N, F) with index (E,), or
    x (B, N, F) with index (B, E). Returns (E, F) or (B, E, F)."""
    if x.dim() == 2:
        return x.index_select(0, index)
    return torch.gather(x, 1, index.unsqueeze(-1).expand(-1, -1, x.shape[-1]))


def edge_features(pos: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
    """(..., E, 5) features [dist, dir_x, dir_y, dir_z, 1/(dist^2+1e-6)].

    Args:
        pos: (N, 3) node positions, or (B, N, 3).
        edge_index: (2, E) [row (source), col (target)], or (B, 2, E).
    """
    row, col = edge_index[..., 0, :], edge_index[..., 1, :]
    diff = gather_nodes(pos, col) - gather_nodes(pos, row)
    dist = torch.linalg.vector_norm(diff, dim=-1, keepdim=True) + 1e-8
    direction = diff / dist
    inv_dist_sq = 1.0 / (dist ** 2 + 1e-6)
    return torch.cat([dist, direction, inv_dist_sq], dim=-1)
