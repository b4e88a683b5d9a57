"""Rollout-aware checkpoint selection on the GPU (port of
``scripts/select_checkpoint.py``).

    python -m nbody_gnn_hpc_torch.select_checkpoint             # rank + report
    python -m nbody_gnn_hpc_torch.select_checkpoint --promote   # + selected_model.pt
    python -m nbody_gnn_hpc_torch.select_checkpoint --device cpu ...  # asked

Scores every checkpoint a training run saved (periodic, best, final) by
full-horizon rollout RMSE on held-out validation trajectories (the first
``--n-sims`` of the last 20 % of the sorted ``*_trajectory.h5`` names),
prints the ranking, writes ``checkpoint_selection.json`` and optionally
copies the winner to ``<models-dir>/selected_model.pt``.  One-step
validation loss anticorrelates with rollout quality (RESULTS.md), and short
horizons mispredict the full-horizon ranking (predict/selection.py), hence
the full horizon by default.  Reading the files needs h5py.
"""

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser(
        description="Rollout-aware checkpoint selection")
    parser.add_argument("--models-dir", "-m", default="./models")
    parser.add_argument("--config-path", "-c", default="./models/config.json")
    parser.add_argument("--data-dir", "-d", default="./data")
    parser.add_argument("--horizon", "-k", type=int, default=None,
                        help="Rollout steps per scored checkpoint (default: "
                             "the longest the val trajectories support; "
                             "short horizons mispredict the full-horizon "
                             "ranking, see predict/selection.py)")
    parser.add_argument("--n-sims", type=int, default=4,
                        help="Held-out val trajectories to score against")
    parser.add_argument("--start-step", type=int, default=5,
                        help="Rollout start (the published protocol starts "
                             "at 5)")
    parser.add_argument("--metric", choices=("position_rmse",
                                             "velocity_rmse"),
                        default="position_rmse")
    parser.add_argument("--promote", action="store_true",
                        help="Copy the winner to "
                             "<models-dir>/selected_model.pt")
    parser.add_argument("--output", "-o", default=None,
                        help="Selection report JSON "
                             "(default <models-dir>/checkpoint_selection.json)")
    parser.add_argument("--watchdog", type=float, default=None,
                        metavar="SECONDS",
                        help="Exit with a distinctive code if no checkpoint "
                             "finishes scoring for this many seconds (stall "
                             "detection). Must cover the first checkpoint's "
                             "kernel builds. 0 disables.")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.models import model_from_config
    from nbody_gnn_hpc_torch.predict.selection import (discover_checkpoints,
                                                       score_checkpoints,
                                                       select_checkpoint)
    from nbody_gnn_hpc_torch.train.rollout_tune import load_trajectory_tensor
    from nbody_gnn_hpc_torch.utils.watchdog import maybe_watchdog

    device = resolve_device(args.device)  # raises without a card unasked
    with open(args.config_path) as f:
        config = json.load(f)
    k_neighbors = config.get("training_config", {}).get("k_neighbors", 40)
    model = model_from_config(config["model_config"])

    candidates = discover_checkpoints(args.models_dir)
    if not candidates:
        print(f"No checkpoints found in {args.models_dir}")
        return 1

    # The validation split: the last 20 % of the sims by name
    # (generate_data.py:184 puts the first 80 % in the train split).
    ckpt_dir = Path(args.data_dir) / "checkpoints"
    names = sorted(p.name.replace("_trajectory.h5", "")
                   for p in ckpt_dir.glob("*_trajectory.h5"))
    val_names = names[int(0.8 * len(names)):][:args.n_sims]
    if not val_names:
        print(f"No trajectories found in {ckpt_dir}")
        return 1

    val_states = load_trajectory_tensor(ckpt_dir, val_names)
    import h5py

    with h5py.File(ckpt_dir / f"{val_names[0]}_trajectory.h5", "r") as f:
        masses = f["masses"][:].astype(np.float32)

    horizon = args.horizon
    if horizon is None:  # the full horizon (see predict/selection.py)
        horizon = val_states.shape[1] - args.start_step - 1
    if horizon < 1:
        print(f"Val trajectories save only {val_states.shape[1]} states: "
              f"no rollout horizon left after --start-step {args.start_step}")
        return 1
    print(f"Scoring {len(candidates)} checkpoints: {horizon}-step "
          f"rollouts on {len(val_names)} val trajectories "
          f"({', '.join(val_names)})")

    watchdog = maybe_watchdog(args.watchdog,
                              what="checkpoint-scoring progress")
    try:
        scores = score_checkpoints(
            model, candidates, val_states, masses, k_neighbors,
            horizon=horizon, start_step=args.start_step,
            progress_cb=watchdog.beat if watchdog is not None else None,
            device=device)
    finally:
        if watchdog is not None:
            watchdog.stop()  # the report and promotion are host work
    best = select_checkpoint(scores, args.metric)

    print(f"\n{'checkpoint':<28} {'pos RMSE':>12} {'vel RMSE':>14}")
    print("-" * 56)
    for s in scores:
        mark = "  <-- selected" if s["path"] == best["path"] else ""
        print(f"{Path(s['path']).name:<28} {s['position_rmse']:>12.4g} "
              f"{s['velocity_rmse']:>14.4g}{mark}")

    report = {"metric": args.metric, "horizon": horizon,
              "start_step": args.start_step, "val_sims": val_names,
              "scores": scores, "selected": best["path"]}
    out = Path(args.output or Path(args.models_dir)
               / "checkpoint_selection.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"\nReport: {out}")

    if args.promote:
        dst = Path(args.models_dir) / "selected_model.pt"
        shutil.copyfile(best["path"], dst)
        print(f"Promoted {Path(best['path']).name} -> {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
