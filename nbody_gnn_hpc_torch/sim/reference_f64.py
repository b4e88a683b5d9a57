"""Float64 reference-protocol ground truth (host NumPy, CPU).

The port's own copy of ``nbody_gnn_hpc_tpu/sim/reference_f64.py``, which
this package does not import.  The reference simulates in NumPy float64
(``src/hpc/nbody.py:179-184``) and stores f64 trajectories; its published
RMSE numbers are measured against that ground truth.  The device simulator
runs in float32, pointwise different at long horizons because the system is
chaotic, so like-for-like accuracy figures need an f64 oracle with the
reference's exact semantics:

  * softened inverse-square gravity, ``r^2 = |d|^2 + softening^2``,
    self-interaction excluded (``nbody.py:45-61``);
  * KDK leapfrog: half-kick, drift, recompute accel, half-kick
    (``nbody.py:202-218``);
  * ``run(n_steps, save_interval=1)`` records the initial state plus every
    step -> ``n_steps + 1`` states (``nbody.py:232-241``);
  * ICs drawn from the exact MT19937 streams (seed 9999+i for eval sims,
    shared f32 masses from seed 42, ``evaluate.py:76-92``); the f32 masses
    promote to f64 in arithmetic.

Vectorised NumPy on the host CPU: the validation oracle, not a production
path.
"""

import time
from typing import NamedTuple, Tuple

import numpy as np

from nbody_gnn_hpc_torch.device import G, SOFTENING
from nbody_gnn_hpc_torch.sim.initial_conditions import (
    random_initial_conditions, shared_masses)


def accelerations_f64(positions: np.ndarray, masses: np.ndarray,
                      softening: float = SOFTENING) -> np.ndarray:
    """Softened pairwise gravitational accelerations in float64.

    Semantics of ``compute_accelerations_direct`` (``nbody.py:22-66``):
    a_i = G sum_{j != i} m_j (x_j - x_i) / (|x_j - x_i|^2 + softening^2)^{3/2}.
    """
    pos = np.asarray(positions, dtype=np.float64)
    m = np.asarray(masses, dtype=np.float64)
    delta = pos[np.newaxis, :, :] - pos[:, np.newaxis, :]  # d[i,j] = x_j - x_i
    r2 = np.einsum("ijk,ijk->ij", delta, delta) + softening * softening
    inv_r3 = r2 ** -1.5
    np.fill_diagonal(inv_r3, 0.0)  # i == j excluded (nbody.py:46)
    return G * np.einsum("ij,j,ijk->ik", inv_r3, m, delta)


def total_energy_f64(positions: np.ndarray, velocities: np.ndarray,
                     masses: np.ndarray,
                     softening: float = SOFTENING) -> Tuple[float, float, float]:
    """(kinetic, potential, total) in float64 (``nbody.py:101-130``)."""
    pos = np.asarray(positions, np.float64)
    vel = np.asarray(velocities, np.float64)
    m = np.asarray(masses, np.float64)
    ke = 0.5 * float(np.sum(m * np.einsum("ik,ik->i", vel, vel)))
    delta = pos[np.newaxis, :, :] - pos[:, np.newaxis, :]
    r = np.sqrt(np.einsum("ijk,ijk->ij", delta, delta) + softening * softening)
    inv_r = 1.0 / r
    np.fill_diagonal(inv_r, 0.0)
    # Each unordered pair once (reference loops j > i).
    pe = -0.5 * G * float(np.einsum("i,ij,j->", m, inv_r, m))
    return ke, pe, ke + pe


class TrajectoryF64(NamedTuple):
    """Stacked f64 trajectory: (n_saved, N, 3) positions/velocities/
    accelerations, (n_saved,) times, (N,) masses."""
    positions: np.ndarray
    velocities: np.ndarray
    accelerations: np.ndarray
    times: np.ndarray
    masses: np.ndarray


def simulate_f64(positions: np.ndarray, velocities: np.ndarray,
                 masses: np.ndarray, dt: float, n_steps: int,
                 softening: float = SOFTENING,
                 save_interval: int = 1) -> TrajectoryF64:
    """Run the reference's KDK leapfrog in float64 on the host.

    Matches ``NBodySimulator.step``/``run`` (``nbody.py:202-248``): the
    initial state is saved first, then every ``save_interval``-th step.
    """
    pos = np.array(positions, dtype=np.float64)
    vel = np.array(velocities, dtype=np.float64)
    acc = accelerations_f64(pos, masses, softening)

    saved_pos, saved_vel, saved_acc, saved_t = [pos.copy()], [vel.copy()], \
        [acc.copy()], [0.0]
    for step in range(1, n_steps + 1):
        vel += (0.5 * dt) * acc
        pos += dt * vel
        acc = accelerations_f64(pos, masses, softening)
        vel += (0.5 * dt) * acc
        if step % save_interval == 0:
            saved_pos.append(pos.copy())
            saved_vel.append(vel.copy())
            saved_acc.append(acc.copy())
            saved_t.append(step * dt)

    return TrajectoryF64(np.stack(saved_pos), np.stack(saved_vel),
                         np.stack(saved_acc), np.asarray(saved_t),
                         np.asarray(masses))


def protocol_ground_truth(n_test_sims: int = 10, n_particles: int = 200,
                          n_steps: int = 400, dt: float = 0.001,
                          box_size: float = 10.0, seed: int = 9999,
                          mass_seed: int = 42,
                          verbose: bool = False,
                          progress_cb=None) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]:
    """The published evaluation protocol's ground truth, in float64.

    Reproduces ``evaluate.py:76-99``: shared f32 masses from seed
    ``mass_seed``, per-sim ICs from seeds ``seed + i`` (positions and
    velocities only: the IC mass draw is consumed then overridden, and
    accelerations recomputed, as ``evaluate.py:91-92`` does).

    Returns (positions (S, n_steps+1, N, 3) f64, velocities likewise,
    masses (N,) f32).

    ``progress_cb`` (no-argument callable) runs after each finished sim: a
    stall-watchdog beat, since this host-only oracle can run for minutes
    and a caller's device watchdog would otherwise end a healthy
    evaluation during it.
    """
    masses = shared_masses(n_particles, seed=mass_seed)
    all_pos, all_vel = [], []
    for i in range(n_test_sims):
        pos0, vel0, _ = random_initial_conditions(
            n_particles, box_size=box_size, seed=seed + i)
        traj = simulate_f64(pos0, vel0, masses, dt, n_steps)
        all_pos.append(traj.positions)
        all_vel.append(traj.velocities)
        if verbose:
            _, _, te = total_energy_f64(traj.positions[-1],
                                        traj.velocities[-1], masses)
            print(f"  f64 ground truth {i + 1}/{n_test_sims}: "
                  f"final energy {te:.6e}")
        if progress_cb is not None:
            progress_cb()
    return np.stack(all_pos), np.stack(all_vel), masses


def measure_numpy_baseline(n_particles: int = 200, n_steps: int = 50,
                           dt: float = 0.001, seed: int = 42,
                           repeats: int = 3) -> float:
    """Single-core vectorised-NumPy float64 simulation rate of this host, in
    sim-steps per second (best of ``repeats`` runs of ``n_steps``): the
    host-side yardstick beside the reference's Numba baseline estimate
    (BASELINE.md).  Host only; no device is touched."""
    pos0, vel0, masses = random_initial_conditions(n_particles, 10.0,
                                                   seed=seed)
    simulate_f64(pos0, vel0, masses, dt, 5)  # warm caches
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        simulate_f64(pos0, vel0, masses, dt, n_steps)
        best = min(best, time.perf_counter() - t0)
    return n_steps / best
