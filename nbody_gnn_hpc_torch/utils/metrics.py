"""Accuracy metrics for N-body predictions (host-side NumPy).

The port's own copy of ``nbody_gnn_hpc_tpu/utils/metrics.py``, which this
package does not import.  Numerics parity with the reference's
``src/utils/metrics.py``: identical formulas and return contracts for
RMSE/MAE, energy/momentum conservation errors, trajectory divergence, the
aggregator with NaN-on-exception fallbacks, and the text report.  NumPy,
not torch: these run once per evaluation on small arrays.
"""

from typing import Dict, Tuple

import numpy as np

from nbody_gnn_hpc_torch.device import G, SOFTENING


def compute_rmse(predicted: np.ndarray, target: np.ndarray,
                 per_particle: bool = False) -> np.ndarray:
    """RMSE, optionally per particle (parity: ``metrics.py:16-37``)."""
    diff = predicted - target
    if per_particle:
        return np.sqrt(np.mean(diff ** 2, axis=(0, -1)))
    return np.sqrt(np.mean(diff ** 2))


def compute_mae(predicted: np.ndarray, target: np.ndarray,
                per_particle: bool = False) -> np.ndarray:
    """MAE, optionally per particle (parity: ``metrics.py:40-59``)."""
    diff = np.abs(predicted - target)
    if per_particle:
        return np.mean(diff, axis=(0, -1))
    return np.mean(diff)


def compute_energy_error(positions: np.ndarray, velocities: np.ndarray,
                         masses: np.ndarray, G: float = G,
                         softening: float = SOFTENING, *,
                         max_chunk_bytes: int = 2 ** 28
                         ) -> Tuple[np.ndarray, float]:
    """Total energy per step + max relative error vs initial
    (parity: ``metrics.py:62-109``).

    Vectorized over a time *chunk* rather than the whole trajectory: the
    reference loops per timestep and peaks at one ``(N, N, 3)`` slab
    (``metrics.py:85-104``); a fully time-vectorized form needs
    ``O(T * N^2)`` host RAM (terabytes at the N=5000, ~400-step BH-regime
    evaluations of the large-N regime).  Here peak memory is three
    ``(chunk, N, N)`` float64 slabs, with ``chunk`` sized so one slab stays
    under ``max_chunk_bytes`` (default 256 MiB).  Per-timestep reductions
    are unchanged, so results are bitwise identical to the unchunked form.
    """
    n_steps, n = positions.shape[0], positions.shape[1]
    m = np.asarray(masses, np.float64)
    pos = np.asarray(positions, np.float64)
    vel = np.asarray(velocities, np.float64)

    kinetic = 0.5 * np.sum(m[None, :] * np.sum(vel ** 2, axis=-1), axis=-1)

    slab_bytes = n * n * 8
    chunk = int(max(1, min(n_steps, max_chunk_bytes // max(slab_bytes, 1))))
    m_matrix = np.outer(m, m)
    idx = np.arange(n)
    potential = np.empty(n_steps, np.float64)
    # Three preallocated (chunk, N, N) slabs, reused across chunks; every
    # op below writes into them (`out=`) so the hot loop allocates nothing.
    buf = np.empty((chunk, n, n), np.float64)
    tmp = np.empty((chunk, n, n), np.float64)
    acc = np.empty((chunk, n, n), np.float64)
    for t0 in range(0, n_steps, chunk):
        p = pos[t0:t0 + chunk]
        c = p.shape[0]
        b, tm, ds = buf[:c], tmp[:c], acc[:c]
        # Accumulate dist_sq per coordinate axis: same ((x^2+y^2)+z^2)
        # order as np.sum(diff**2, axis=-1) without the (chunk, N, N, 3)
        # displacement tensor.
        np.subtract(p[:, :, None, 0], p[:, None, :, 0], out=b)
        np.multiply(b, b, out=ds)
        for ax in (1, 2):
            np.subtract(p[:, :, None, ax], p[:, None, :, ax], out=b)
            np.multiply(b, b, out=tm)
            np.add(ds, tm, out=ds)
        np.add(ds, softening ** 2, out=ds)
        np.sqrt(ds, out=ds)
        np.divide(1.0, ds, out=ds)  # ds is now inv_r
        ds[:, idx, idx] = 0.0
        np.multiply(ds, m_matrix[None], out=ds)
        potential[t0:t0 + chunk] = -0.5 * G * ds.sum(axis=(1, 2))

    energies = kinetic + potential
    relative_error = np.abs((energies - energies[0]) / energies[0])
    return energies, float(np.max(relative_error))


def compute_momentum_error(velocities: np.ndarray, masses: np.ndarray
                           ) -> Tuple[np.ndarray, float]:
    """Momentum magnitude per step + max relative error
    (parity: ``metrics.py:112-137``)."""
    m = np.asarray(masses, np.float64)
    momentum = np.sum(m[None, :, None] * np.asarray(velocities, np.float64),
                      axis=1)
    momentum_mag = np.linalg.norm(momentum, axis=1)
    initial_mag = max(momentum_mag[0], 1e-10)
    relative_error = np.abs((momentum_mag - momentum_mag[0]) / initial_mag)
    return momentum_mag, float(np.max(relative_error))


def compute_trajectory_divergence(predicted_pos: np.ndarray,
                                  target_pos: np.ndarray) -> Dict[str, float]:
    """Divergence metrics incl. log-linear-fit Lyapunov-like rate
    (parity: ``metrics.py:140-181``)."""
    n_steps = predicted_pos.shape[0]
    distances = np.sqrt(np.sum((predicted_pos - target_pos) ** 2, axis=-1))
    mean_dist_per_step = np.mean(distances, axis=1)
    max_dist_per_step = np.max(distances, axis=1)

    log_dist = np.log(mean_dist_per_step + 1e-10)
    steps = np.arange(n_steps)
    slope = float(np.polyfit(steps, log_dist, 1)[0]) if n_steps > 1 else 0.0

    return {
        "mean_rmse": float(compute_rmse(predicted_pos, target_pos)),
        "final_rmse": float(np.sqrt(np.mean(distances[-1] ** 2))),
        "mean_distance": float(np.mean(mean_dist_per_step)),
        "max_distance": float(np.max(max_dist_per_step)),
        "divergence_rate": slope,
        "distances_per_step": mean_dist_per_step.tolist(),
    }


def compute_all_metrics(predicted_pos: np.ndarray, predicted_vel: np.ndarray,
                        target_pos: np.ndarray, target_vel: np.ndarray,
                        masses: np.ndarray) -> Dict:
    """All metrics with NaN fallbacks (parity: ``metrics.py:184-238``)."""
    metrics = {}
    metrics["position_rmse"] = float(compute_rmse(predicted_pos, target_pos))
    metrics["position_mae"] = float(compute_mae(predicted_pos, target_pos))
    metrics["velocity_rmse"] = float(compute_rmse(predicted_vel, target_vel))
    metrics["velocity_mae"] = float(compute_mae(predicted_vel, target_vel))

    divergence = compute_trajectory_divergence(predicted_pos, target_pos)
    metrics.update({f"trajectory_{k}": v for k, v in divergence.items()})

    try:
        _, pred_energy_error = compute_energy_error(
            predicted_pos, predicted_vel, masses)
        _, target_energy_error = compute_energy_error(
            target_pos, target_vel, masses)
        metrics["predicted_energy_error"] = pred_energy_error
        metrics["target_energy_error"] = target_energy_error
    except Exception:
        metrics["predicted_energy_error"] = float("nan")
        metrics["target_energy_error"] = float("nan")

    try:
        _, pred_momentum_error = compute_momentum_error(predicted_vel, masses)
        _, target_momentum_error = compute_momentum_error(target_vel, masses)
        metrics["predicted_momentum_error"] = pred_momentum_error
        metrics["target_momentum_error"] = target_momentum_error
    except Exception:
        metrics["predicted_momentum_error"] = float("nan")
        metrics["target_momentum_error"] = float("nan")

    return metrics


def format_metrics_report(metrics: Dict) -> str:
    """Readable text report (parity: ``metrics.py:241-280``)."""
    lines = [
        "=" * 50,
        "N-BODY PREDICTION ACCURACY REPORT",
        "=" * 50,
        "",
        "BASIC METRICS",
        "-" * 30,
        f"  Position RMSE:     {metrics.get('position_rmse', float('nan')):.6e}",
        f"  Position MAE:      {metrics.get('position_mae', float('nan')):.6e}",
        f"  Velocity RMSE:     {metrics.get('velocity_rmse', float('nan')):.6e}",
        f"  Velocity MAE:      {metrics.get('velocity_mae', float('nan')):.6e}",
        "",
        "TRAJECTORY ANALYSIS",
        "-" * 30,
        f"  Final Step RMSE:   {metrics.get('trajectory_final_rmse', float('nan')):.6e}",
        f"  Mean Distance:     {metrics.get('trajectory_mean_distance', float('nan')):.6e}",
        f"  Max Distance:      {metrics.get('trajectory_max_distance', float('nan')):.6e}",
        f"  Divergence Rate:   {metrics.get('trajectory_divergence_rate', float('nan')):.6e}",
        "",
        "PHYSICS CONSERVATION",
        "-" * 30,
        f"  Predicted Energy Error:   {metrics.get('predicted_energy_error', float('nan')):.2%}",
        f"  Target Energy Error:      {metrics.get('target_energy_error', float('nan')):.2%}",
        f"  Predicted Momentum Error: {metrics.get('predicted_momentum_error', float('nan')):.2%}",
        f"  Target Momentum Error:    {metrics.get('target_momentum_error', float('nan')):.2%}",
        "",
        "=" * 50,
    ]
    return "\n".join(lines)
