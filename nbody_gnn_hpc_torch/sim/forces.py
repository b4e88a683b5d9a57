"""Softened-gravity forces (port of ``nbody_gnn_hpc_tpu/sim/forces.py``).

Semantics of the reference's ``compute_accelerations_direct``
(``src/hpc/nbody.py:22-66``):

    a_i = sum_{j != i}  G * m_j * (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}

Below ``PALLAS_MIN_N`` the broadcast form runs on any device (the JAX
package uses no Pallas kernel there either).  At and above it the JAX
package dispatches its symmetric Pallas kernel on the TPU; here CUDA
tensors go to its Hopper port, :func:`accelerations_symmetric` (kernel 6,
``csrc/pairwise.cu``), and CPU tensors to the blocked form.
"""

import torch

from nbody_gnn_hpc_torch.device import G, SOFTENING
from nbody_gnn_hpc_torch.ops.pairwise import accelerations_symmetric

PALLAS_MIN_N = 2048


def pairwise_accelerations(positions: torch.Tensor, masses: torch.Tensor,
                           softening: float = SOFTENING) -> torch.Tensor:
    """Direct O(N^2) accelerations: positions (..., N, 3), masses (..., N)
    -> (..., N, 3)."""
    soft2 = softening ** 2
    gm = G * masses
    x, y, z = positions.unbind(-1)
    # d*[..., i, j] = coord_j - coord_i (reference nbody.py:47-49 sign).
    dx = x.unsqueeze(-2) - x.unsqueeze(-1)
    dy = y.unsqueeze(-2) - y.unsqueeze(-1)
    dz = z.unsqueeze(-2) - z.unsqueeze(-1)
    d2 = dx * dx + dy * dy + dz * dz
    inv_r = torch.rsqrt(d2 + soft2)
    f = gm.unsqueeze(-2) * (inv_r * inv_r * inv_r)  # G m_j / r^3
    # Coincident pairs (self-pairs included) exert zero force. f * dx == 0
    # is not overflow-safe: at solar-scale masses G*m/soft^3 exceeds f32
    # max and inf * 0 = NaN; d2 == 0 picks exactly those pairs.
    f = torch.where(d2 > 0, f, torch.zeros_like(f))
    return torch.stack([(f * dx).sum(-1), (f * dy).sum(-1),
                        (f * dz).sum(-1)], dim=-1)


def blocked_accelerations(positions: torch.Tensor, masses: torch.Tensor,
                          softening: float = SOFTENING,
                          block: int = 1024) -> torch.Tensor:
    """Direct accelerations of one (N, 3) system, receivers in blocks of
    ``block`` rows: peak intermediate (block, N, 3) instead of (N, N, 3)."""
    soft2 = softening ** 2
    out = []
    for s in range(0, positions.shape[0], block):
        diff = positions[None, :, :] - positions[s:s + block, None, :]
        d2 = (diff * diff).sum(-1)
        inv_r = torch.rsqrt(d2 + soft2)
        factor = G * masses[None, :] * inv_r * inv_r * inv_r
        factor = torch.where(d2 > 0, factor, torch.zeros_like(factor))
        out.append(torch.einsum("ij,ijk->ik", factor, diff))
    return torch.cat(out)


def accelerations(positions: torch.Tensor, masses: torch.Tensor,
                  softening: float = SOFTENING) -> torch.Tensor:
    """Dispatch: broadcast form below ``PALLAS_MIN_N``; above it the
    symmetric CUDA kernel for device tensors and the blocked form on the
    CPU, one system at a time for a (B, N, 3) input."""
    n = positions.shape[-2]
    if n < PALLAS_MIN_N:
        return pairwise_accelerations(positions, masses, softening)
    if positions.dim() > 2:
        return torch.stack([accelerations(p, m, softening)
                            for p, m in zip(positions, masses)])
    if positions.device.type == "cpu":
        return blocked_accelerations(positions, masses, softening)
    return accelerations_symmetric(positions, masses, softening)
