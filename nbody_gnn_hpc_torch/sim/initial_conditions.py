"""Host-side initial conditions with the reference's RNG streams (a copy of
``nbody_gnn_hpc_tpu/sim/initial_conditions.py``, which this package does
not import).

The reference seeds NumPy's RNG and draws, in order: positions, velocities,
masses (``src/hpc/nbody.py:174-181``).  The evaluation protocol keys on
seeds 9999+i with shared masses from seed 42 (``evaluate.py:76-88``).
"""

from typing import Optional, Tuple

import numpy as np


def random_initial_conditions(
    n_particles: int,
    box_size: float = 1.0,
    mass_range: Tuple[float, float] = (1e10, 1e12),
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Positions/velocities/masses drawn as the reference constructor does:
    positions = (rand(n, 3) - 0.5) * box_size; velocities = (rand(n, 3) -
    0.5) * 0.1 * box_size; masses = uniform(lo, hi, n).  ``seed=None``
    draws from NumPy's global RNG (reference behaviour)."""
    rng = np.random.RandomState(seed) if seed is not None else np.random
    positions = (rng.rand(n_particles, 3) - 0.5) * box_size
    velocities = (rng.rand(n_particles, 3) - 0.5) * 0.1 * box_size
    masses = rng.uniform(mass_range[0], mass_range[1], n_particles)
    return positions, velocities, masses


def shared_masses(n_particles: int, seed: int = 42,
                  mass_range: Tuple[float, float] = (1e10, 1e12)) -> np.ndarray:
    """The shared float32 masses of datagen and evaluation
    (``generate_data.py:108-109``, ``evaluate.py:76-77``)."""
    rng = np.random.RandomState(seed)
    return rng.uniform(mass_range[0], mass_range[1], n_particles).astype(np.float32)
