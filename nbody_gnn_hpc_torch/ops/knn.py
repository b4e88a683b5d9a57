"""On-device graph construction: k-NN and fully-connected edge sets
(port of ``nbody_gnn_hpc_tpu/ops/knn.py``).

The k-NN is a dense distance matrix + ``torch.topk`` with the self-distance
pushed to +inf, on whatever device the positions live on.  The edge *set*
per row matches the JAX package's; the order within a row's k neighbours
may differ on exact ties, which the sum-aggregation GNN does not see.

Every builder emits the row-regular layout of the reference
(``train.py:118-120``): ``edge_index[0] == repeat(arange(N), k)``.
"""

from typing import Optional

import numpy as np
import torch

from nbody_gnn_hpc_torch.device import resolve_device

# Above this particle count the row-blocked form is used: the dense form
# materialises an (N, N) f32 distance matrix, the blocked one (KNN_BLOCK, N).
KNN_DENSE_MAX = 2048
KNN_BLOCK = 512


def _knn_rows(query: torch.Tensor, query_ids: torch.Tensor,
              positions: torch.Tensor, k: int) -> torch.Tensor:
    """(..., Q, k) nearest-first neighbour indices of ``query`` rows among
    ``positions`` (..., N, 3), excluding each row's own id."""
    d2 = ((query.unsqueeze(-2) - positions.unsqueeze(-3)) ** 2).sum(-1)
    ids = torch.arange(positions.shape[-2], device=positions.device)
    # where, not eye*inf: 0*inf would poison the off-diagonals with NaN.
    d2 = torch.where(query_ids[:, None] == ids[None, :],
                     torch.full_like(d2, float("inf")), d2)
    return torch.topk(-d2, k, dim=-1).indices


def knn_edge_index(positions: torch.Tensor, k: int,
                   block_size: Optional[int] = None) -> torch.Tensor:
    """k nearest neighbours of each particle, excluding self.

    Args:
        positions: (N, 3), or (B, N, 3) for one graph per system.
        k: neighbour count (k < N).
        block_size: force the row-blocked form with this many rows per
            block (default: dense for N <= KNN_DENSE_MAX, else KNN_BLOCK).

    Returns:
        int64 edge_index (2, N*k), or (B, 2, N*k): row i repeated k times,
        then its k nearest neighbours.
    """
    n = positions.shape[-2]
    if block_size is None and n > KNN_DENSE_MAX:
        block_size = KNN_BLOCK
    ids = torch.arange(n, device=positions.device)
    if block_size is not None and block_size < n:
        # Each row's distances use the same elementwise ops as the dense
        # form, so the selected sets are identical.
        idx = torch.cat([
            _knn_rows(positions[..., s:s + block_size, :],
                      ids[s:s + block_size], positions, k)
            for s in range(0, n, block_size)], dim=-2)
    else:
        idx = _knn_rows(positions, ids, positions, k)
    row = ids.repeat_interleave(k)
    col = idx.reshape(*idx.shape[:-2], n * k)
    return torch.stack([row.expand_as(col), col], dim=-2)


def fully_connected_edge_index(n: int) -> np.ndarray:
    """All ordered pairs (i, j), i != j (``train.py:93-99``), row-major."""
    row = np.repeat(np.arange(n), n)
    col = np.tile(np.arange(n), n)
    mask = row != col
    return np.stack([row[mask], col[mask]]).astype(np.int64)


def is_row_regular(edge_index, n_nodes: int) -> bool:
    """True iff ``edge_index[0] == repeat(arange(n_nodes), E // n_nodes)``,
    the layout every builder above emits."""
    edges = np.asarray(torch.as_tensor(edge_index).cpu())
    n_edges = edges.shape[-1]
    if n_nodes == 0 or n_edges % n_nodes != 0:
        return False
    return bool(np.all(
        edges[..., 0, :] == np.repeat(np.arange(n_nodes), n_edges // n_nodes)))


def edge_index_for(n_particles: int, k_neighbors, positions=None,
                   device=None) -> torch.Tensor:
    """Reference edge policy (``train.py:91-122``): fully connected when k
    is None or k >= N-1, else k-NN from ``positions`` (a tensor). Edges
    live on the positions' device, else on ``resolve_device(device)``."""
    if k_neighbors is None or k_neighbors >= n_particles - 1:
        dev = (positions.device if positions is not None
               else resolve_device(device))
        return torch.as_tensor(fully_connected_edge_index(n_particles),
                               device=dev)
    if positions is None:
        raise ValueError("positions required for k-NN edges")
    return knn_edge_index(positions, int(k_neighbors))
