"""Energy and momentum diagnostics on the device (port of
``nbody_gnn_hpc_tpu/sim/energy.py``).

Semantics of the reference's ``compute_total_energy``
(``src/hpc/nbody.py:101-130``): kinetic = sum 0.5 m v^2; potential =
-G sum_{i<j} m_i m_j / sqrt(r^2 + eps^2), as a masked pairwise reduction.
"""

from typing import Tuple

import torch

from nbody_gnn_hpc_torch.device import G, SOFTENING

# At and above this N the dense form's (N, N, 3) difference tensor is too
# large (1.2 GB in float32 at N=10k); the row-blocked sum takes over.
BLOCKED_MIN_N = 2048
PE_BLOCK = 512  # rows per block: a (PE_BLOCK, N) pair plane


def kinetic_energy(velocities: torch.Tensor,
                   masses: torch.Tensor) -> torch.Tensor:
    """0.5 * sum_i m_i |v_i|^2: shapes (..., N, 3), (..., N) -> (...)."""
    return 0.5 * (masses * (velocities * velocities).sum(-1)).sum(-1)


def _inverse_distances(rows: torch.Tensor, positions: torch.Tensor,
                       first_row: int, softening: float) -> torch.Tensor:
    """1 / sqrt(|x_i - x_j|^2 + eps^2) of ``rows`` (..., R, 3) against all
    ``positions`` (..., N, 3), zero at the self pairs (row r is particle
    ``first_row + r``)."""
    diff = rows.unsqueeze(-2) - positions.unsqueeze(-3)
    inv_r = torch.rsqrt((diff * diff).sum(-1) + softening ** 2)
    r = torch.arange(rows.shape[-2], device=rows.device)
    inv_r[..., r, first_row + r] = 0.0
    return inv_r


def potential_energy(positions: torch.Tensor, masses: torch.Tensor,
                     softening: float = SOFTENING) -> torch.Tensor:
    """-G * sum_{i<j} m_i m_j / sqrt(|x_i - x_j|^2 + eps^2), shape (...).

    Computed with masses normalised by their mean so the pairwise product
    stays O(1): m_i * m_j overflows float32 beyond masses ~1e19 (solar
    scenes use ~1e30).  The prefactor is reapplied in an overflow-safe
    order: ((G * scale) * sum) * scale.

    N >= ``BLOCKED_MIN_N`` sums row blocks of ``PE_BLOCK`` particles, so
    the diagnostic runs in O(PE_BLOCK * N) memory at any N.
    """
    n = positions.shape[-2]
    scale = masses.mean(-1, keepdim=True)
    nm = masses / scale
    block = PE_BLOCK if n >= BLOCKED_MIN_N else max(n, 1)
    s = torch.zeros(positions.shape[:-2], dtype=positions.dtype,
                    device=positions.device)
    for r0 in range(0, n, block):
        inv_r = _inverse_distances(positions[..., r0:r0 + block, :],
                                   positions, r0, softening)
        mm = nm[..., r0:r0 + block, None] * nm[..., None, :]
        s = s + (mm * inv_r).sum((-2, -1))
    scale = scale.squeeze(-1)
    return -0.5 * ((G * scale) * s) * scale  # 0.5: (i, j) and (j, i)


def total_energy(positions: torch.Tensor, velocities: torch.Tensor,
                 masses: torch.Tensor, softening: float = SOFTENING
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(kinetic, potential, total), the return contract of
    ``compute_total_energy`` (``nbody.py:101-130``)."""
    ke = kinetic_energy(velocities, masses)
    pe = potential_energy(positions, masses, softening)
    return ke, pe, ke + pe


def total_momentum(velocities: torch.Tensor,
                   masses: torch.Tensor) -> torch.Tensor:
    """sum_i m_i v_i, shape (..., 3).  Conserved exactly by pairwise
    forces (Newton's third law)."""
    return (masses.unsqueeze(-1) * velocities).sum(-2)
