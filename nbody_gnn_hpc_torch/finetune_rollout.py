"""Rollout-aware fine-tuning of a trained GNN on the GPU (port of
``scripts/finetune_rollout.py``).

    python -m nbody_gnn_hpc_torch.finetune_rollout --curriculum 8:1500,16:900
    python -m nbody_gnn_hpc_torch.finetune_rollout --device cpu ...  # asked

Starts from a checkpoint (default ``models/best_model.pt``), fine-tunes it
with the K-step unrolled objective (:mod:`nbody_gnn_hpc_torch.train.
rollout_tune`) on the train split of the trajectory files (the first 80 %
of the sorted ``*_trajectory.{h5,npz}`` names), and saves
``best_rollout_model.pt`` in the checkpoint format of the JAX package, with
the ``finetune`` record of the curriculum.  Reading HDF5 files needs h5py,
npz files do not; :func:`finetune_curriculum` takes trajectories already in
memory.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def parse_curriculum(spec: str):
    """'8:1500,16:900' -> [(8, 1500), (16, 900)] with validation."""
    try:
        rungs = [(int(h), int(s)) for h, _, s in
                 (part.partition(":") for part in spec.split(","))]
    except ValueError:
        raise ValueError(f"bad curriculum spec: {spec!r} "
                         "(expected 'K:steps[,K:steps...]')") from None
    if any(h < 1 or s < 1 for h, s in rungs):
        raise ValueError(f"bad curriculum spec: {spec!r} "
                         "(horizons and steps must be >= 1)")
    return rungs


def build_parser():
    parser = argparse.ArgumentParser(description="Rollout-aware fine-tuning")
    parser.add_argument("--model-path", "-m", default="./models/best_model.pt")
    parser.add_argument("--config-path", "-c", default="./models/config.json")
    parser.add_argument("--data-dir", "-d", default="./data")
    parser.add_argument("--output", "-o",
                        default="./models/best_rollout_model.pt")
    parser.add_argument("--horizon", "-k", type=int, default=8)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--curriculum", default=None,
                        help="Comma-separated K:steps rungs run in sequence "
                             "in one process (e.g. '8:1500,16:900', the "
                             "measured production recipe, RESULTS.md); "
                             "overrides --horizon/--steps")
    parser.add_argument("--batch-size", "-b", type=int, default=8)
    parser.add_argument("--learning-rate", "-lr", type=float, default=5e-5)
    parser.add_argument("--max-sims", type=int, default=None,
                        help="Limit trajectories loaded (memory/speed)")
    parser.add_argument("--watchdog", type=float, default=None,
                        metavar="SECONDS",
                        help="Exit with a distinctive code if no logged "
                             "step chunk completes for this many seconds "
                             "(stall detection). Must cover each rung's "
                             "first chunk, kernel builds included. "
                             "0 disables.")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    return parser


def finetune_curriculum(model, trajectories, norm_stats, masses, rungs, *,
                        output, base, model_config, k_neighbors=40,
                        batch_size=8, learning_rate=5e-5, watchdog_s=None):
    """Run ``rungs`` [(horizon, steps), ...] in sequence, each from the
    previous rung's best parameters, and save the result to ``output``
    with the ``finetune`` record.  The watchdog stays armed until the file
    is written.  Returns the per-rung records."""
    from nbody_gnn_hpc_torch.io import params_to_jax, save_checkpoint
    from nbody_gnn_hpc_torch.train.rollout_tune import finetune_rollout
    from nbody_gnn_hpc_torch.utils.watchdog import maybe_watchdog

    watchdog = maybe_watchdog(watchdog_s, what="fine-tune step progress")
    histories = []
    try:
        for i, (horizon, steps) in enumerate(rungs, 1):
            print(f"Fine-tuning rung {i}/{len(rungs)}: horizon={horizon}, "
                  f"steps={steps}, batch={batch_size}, lr={learning_rate}")
            _, history = finetune_rollout(
                model, trajectories, norm_stats, masses,
                k_neighbors=k_neighbors, horizon=horizon,
                batch_size=batch_size, learning_rate=learning_rate,
                n_steps=steps,
                progress_cb=watchdog.beat if watchdog is not None else None)
            histories.append({"horizon": horizon, "steps": steps,
                              "history": history})
        save_checkpoint(output, params=params_to_jax(model.state_dict()),
                        norm_stats=norm_stats,
                        history=histories[-1]["history"],
                        model_config=model_config,
                        extra={"finetune": {"curriculum": list(rungs),
                                            "base": str(base),
                                            "rungs": histories}})
    finally:
        if watchdog is not None:
            watchdog.stop()
    print(f"Saved {output}")
    return histories


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.io import (CheckpointManager, load_checkpoint,
                                        load_into)
    from nbody_gnn_hpc_torch.models import model_from_config
    from nbody_gnn_hpc_torch.ops import launch_line
    from nbody_gnn_hpc_torch.train.rollout_tune import load_trajectory_tensor

    device = resolve_device(args.device)  # raises without a card unasked
    print(f"Device: {device}")
    rungs = parse_curriculum(args.curriculum) if args.curriculum \
        else [(args.horizon, args.steps)]
    with open(args.config_path) as f:
        config = json.load(f)
    model_config = config["model_config"]
    k_neighbors = config.get("training_config", {}).get("k_neighbors", 40)

    model = model_from_config(model_config,
                              dtype_override="float32").to(device)
    norm_stats = load_into(model, load_checkpoint(args.model_path))
    if norm_stats is None:
        print(f"{args.model_path} has no norm_stats: the unrolled objective "
              f"normalises with the statistics the model was trained on")
        return 1

    ckpt_dir = Path(args.data_dir) / "checkpoints"
    manager = CheckpointManager(str(ckpt_dir))
    names = manager.trajectory_names()
    # The train split only: the first 80 % (generate_data.py:184).
    names = names[:int(0.8 * len(names))]
    if args.max_sims:
        names = names[:args.max_sims]
    if not names:
        print(f"No trajectories found in {ckpt_dir}: the unrolled objective "
              f"needs raw trajectory files (run generate_data; windowed "
              f"datasets alone are not enough)")
        return 1
    print(f"Loading {len(names)} trajectories...")
    trajectories = load_trajectory_tensor(ckpt_dir, names)
    masses = manager.load_trajectory(names[0])["masses"].astype(np.float32)

    finetune_curriculum(
        model, trajectories, norm_stats, masses, rungs, output=args.output,
        base=args.model_path, model_config=model_config,
        k_neighbors=k_neighbors, batch_size=args.batch_size,
        learning_rate=args.learning_rate, watchdog_s=args.watchdog)
    print(launch_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
