"""Rollout-aware checkpoint selection (port of
``nbody_gnn_hpc_tpu/predict/selection.py``).

One-step validation loss anticorrelates with autoregressive rollout quality
(RESULTS.md "Caveats"): two identically configured production runs landed
at 394-step position RMSE 121.9 and 580.7 depending only on which epoch
best-validation selection hit.  This scores each saved checkpoint by
rollout error against held-out validation trajectories, the quantity that
matters when serving, and picks the winner.

Each checkpoint is one batched rollout (``Predictor.predict_rollout_batch``)
through one :class:`Predictor` that loads every file in turn; the port
compiles nothing, so there is no cache to keep across files.
"""

import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from nbody_gnn_hpc_torch.io import load_checkpoint
from nbody_gnn_hpc_torch.predict.predictor import Predictor

__all__ = ["discover_checkpoints", "score_checkpoints", "select_checkpoint"]


def discover_checkpoints(models_dir) -> List[Path]:
    """Candidate checkpoints in a training output directory: the periodic
    ``checkpoint_epoch_K.pt`` saves (epoch order), then ``best_model.pt``
    and ``final_model.pt`` (the reference's candidates,
    ``train.py:519-533``)."""
    models_dir = Path(models_dir)
    epochs = sorted(models_dir.glob("checkpoint_epoch_*.pt"),
                    key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    named = [models_dir / n for n in ("best_model.pt", "final_model.pt")
             if (models_dir / n).exists()]
    return epochs + named


def score_checkpoints(model, checkpoint_paths: Sequence,
                      val_states: np.ndarray, masses: np.ndarray,
                      k_neighbors: Optional[int],
                      horizon: Optional[int] = None,
                      start_step: int = 5,
                      progress_cb=None, device=None) -> List[Dict]:
    """Score checkpoints by rollout RMSE on held-out trajectories.

    ``val_states``: (S, T, N, 6) raw [pos, vel] sequences
    (``load_trajectory_tensor``'s layout).  Each checkpoint is rolled out
    from ``val_states[:, start_step]`` for ``horizon`` steps in one batch
    and scored against steps ``start_step+1 .. start_step+horizon``.
    ``horizon=None`` scores at the longest horizon the trajectories allow
    (``T - start_step - 1``): short horizons mispredict the full-horizon
    ranking (a horizon-50 sweep ranked first a checkpoint 3x worse at 394
    steps), while full-horizon validation scores track the test protocol
    to ~3 %.

    ``progress_cb``: optional no-arg callable invoked after each
    checkpoint's scores are read back (a stall-watchdog beat hook).
    ``device``: ``cuda`` by default, ``"cpu"`` only when asked for.

    Returns one dict per checkpoint, in input order: ``{"path",
    "position_rmse", "velocity_rmse"}``; a file without ``norm_stats``
    scores ``inf`` and carries ``"skipped"``.
    """
    S, T, N, _ = val_states.shape
    if horizon is None:
        horizon = T - start_step - 1
    if horizon < 1 or start_step + horizon + 1 > T:
        raise ValueError(f"horizon {horizon} from step {start_step} needs "
                         f"{start_step + horizon + 1} saved states, have {T}")
    gt = val_states[:, start_step + 1:start_step + 1 + horizon]
    pos0 = val_states[:, start_step, :, :3]
    vel0 = val_states[:, start_step, :, 3:]

    predictor = Predictor(model, device=device, k_neighbors=k_neighbors)
    results = []
    for path in checkpoint_paths:
        if load_checkpoint(path).get("norm_stats") is None:
            # Norm stats are load-bearing for inference (predict.py:42-52);
            # scoring without them would rank a garbage-but-finite rollout.
            warnings.warn(f"{path}: no norm_stats — excluded from selection")
            results.append({"path": str(path),
                            "position_rmse": float("inf"),
                            "velocity_rmse": float("inf"),
                            "skipped": "no norm_stats"})
            continue
        predictor.load_model(str(path))
        out = predictor.predict_rollout_batch(pos0, vel0, masses, horizon)
        ai_pos = out["positions"][:, 1:]
        ai_vel = out["velocities"][:, 1:]
        results.append({
            "path": str(path),
            "position_rmse": float(np.sqrt(np.mean(
                (ai_pos - gt[..., :3]) ** 2))),
            "velocity_rmse": float(np.sqrt(np.mean(
                (ai_vel - gt[..., 3:]) ** 2))),
        })
        if progress_cb is not None:
            progress_cb()  # one checkpoint scored and read back
    return results


def select_checkpoint(scores: List[Dict],
                      metric: str = "position_rmse") -> Dict:
    """The winning entry (lowest ``metric``; NaN and inf lose)."""
    def key(s):
        v = s[metric]
        return (not np.isfinite(v), v)
    return min(scores, key=key)
