"""The one-command pipeline on the GPU (port of ``scripts/run_demo.py``):
clean -> datagen -> train -> select -> fine-tune -> evaluate -> CSV.

    python -m nbody_gnn_hpc_torch.run_demo --production
    python -m nbody_gnn_hpc_torch.run_demo --production --trajectory-format npz
    python -m nbody_gnn_hpc_torch.run_demo --device cpu ...   # CPU, asked

The JAX runner's stage table, flags, mode expansion (``--production``,
``--reference-protocol``, ``--resume``, ``--watchdog``) and clean manifest.
Each stage is one of the port's commands, ``python -m
nbody_gnn_hpc_torch.<command>``, in a process of its own; the run stops at
the first stage that fails, and a stage's stall watchdog (exit code 117)
gets the ``--resume`` hint.  The workspace is the current directory: the
stages read and write its ``data/``, ``models/`` and ``results/``, and
unless ``--no-clean`` or ``--resume`` is given the run first deletes what
``CLEAN_MANIFEST`` lists there (``models/best_model.pt`` among them).

Two flags are the port's own: ``--device`` goes to every stage that drives
the device (all but the CSV export, which reads files), and
``--trajectory-format`` to datagen: ``npz`` (which needs ``--no-windows``,
set by ``--production``) writes trajectory files that need no h5py, for a
machine without it.  HDF5 stays the default.  The JAX datagen argv's
``--workers`` has no counterpart in the port (``OMITTED_FLAGS``).
"""

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from nbody_gnn_hpc_torch.config import TrainingConfig
from nbody_gnn_hpc_torch.io.checkpoint import TRAJECTORY_FORMATS
from nbody_gnn_hpc_torch.utils.watchdog import STALL_EXIT_CODE

PACKAGE = "nbody_gnn_hpc_torch"

# ---------------------------------------------------------------------------
# Workspace cleaning: everything removable is listed here, as glob patterns
# relative to the workspace. ``fresh_data_only`` entries survive when the
# user asked to reuse existing datasets (--skip-datagen).
# ---------------------------------------------------------------------------

CLEAN_MANIFEST = (
    # (glob pattern, removed when --skip-datagen?)
    ("results", False),
    ("models/best_model.pt", False),
    ("models/final_model.pt", False),
    ("models/checkpoint_epoch_*.pt", False),
    ("models/selected_model.pt", False),
    ("models/checkpoint_selection.json", False),
    ("models/best_rollout_model.pt", False),
    ("models/training_history.json", False),
    ("models/config.json", False),
    ("data/checkpoints", True),
    ("data/train_dataset.h5", True),
    ("data/val_dataset.h5", True),
)

WORKSPACE_DIRS = ("data", "models", "results")

# Flags of the JAX stage argv that the port's command has not: (command,
# flag); each takes one value.
OMITTED_FLAGS = (("generate_data", "--workers"),)


def clean_workspace(root: Path, keep_data: bool) -> None:
    banner("Cleaning Previous Results")
    for pattern, is_data in CLEAN_MANIFEST:
        if is_data and keep_data:
            continue
        for target in sorted(root.glob(pattern)):
            if target.is_dir():
                shutil.rmtree(target)
            else:
                target.unlink()
            print(f"  Deleted: {target.relative_to(root)}")
    for name in WORKSPACE_DIRS:
        (root / name).mkdir(exist_ok=True)
    print("  Clean complete!\n")


# ---------------------------------------------------------------------------
# Stage table
# ---------------------------------------------------------------------------

@dataclass
class Stage:
    title: str
    # (args, cfg, workspace) -> [command, flags...]
    argv: Callable[[argparse.Namespace, TrainingConfig, Path], List[str]]
    # Returns a message if the stage should be skipped, else None.
    skip: Callable[[argparse.Namespace], Optional[str]] = lambda a: None
    # Raises SystemExit with a message if prerequisites are missing.
    precheck: Callable[[argparse.Namespace, Path], None] = \
        lambda a, root: None


def _datagen_argv(args, cfg, root):
    argv = ["generate_data",
            "--particles", str(cfg.particles),
            "--simulations", str(cfg.simulations),
            "--steps", str(cfg.steps),
            "--sequence-length", str(cfg.sequence_length),
            "--compression", args.compression]
    if args.no_windows:
        argv += ["--no-windows"]
    return (argv + _watchdog_argv(args)
            + ["--trajectory-format", args.trajectory_format]
            + _device_argv(args))


def _watchdog_argv(args):
    # resolve_mode normalized 0 -> None, so a set value is always positive.
    return (["--watchdog", str(args.watchdog)]
            if args.watchdog is not None else [])


def _device_argv(args):
    return ["--device", args.device] if args.device else []


def _train_argv(args, cfg, root):
    epochs = args.epochs if args.epochs is not None else cfg.epochs
    argv = ["train_model", "--physics-loss", "--epochs", str(epochs)]
    if args.max_samples:
        argv += ["--max-samples", str(args.max_samples)]
    if args.resume:
        argv += ["--resume", "auto"]
    return argv + _watchdog_argv(args) + _device_argv(args)


def _select_argv(args, cfg, root):
    # No --horizon: the command defaults to the full horizon the saved val
    # trajectories support (short-horizon scores mispredict full-horizon
    # ranking, predict/selection.py), and adapts to whatever data
    # --skip-datagen reuses.
    return (["select_checkpoint", "--promote"] + _watchdog_argv(args)
            + _device_argv(args))


def _finetune_argv(args, cfg, root):
    # The measured production recipe (RESULTS.md): two-rung curriculum from
    # the near-identity epoch-10 checkpoint. With --rollout-select the
    # selection winner is the base instead (so both stages compose); the
    # fallback is the command's default (best_model.pt) on short runs that
    # never saved epoch 10.
    argv = ["finetune_rollout", "--curriculum", "8:1500,16:900",
            "-o", "./models/best_rollout_model.pt"]
    if args.rollout_select:
        argv += ["-m", "./models/selected_model.pt"]
    elif (root / "models/checkpoint_epoch_10.pt").exists():
        argv += ["-m", "./models/checkpoint_epoch_10.pt"]
    return argv + _watchdog_argv(args) + _device_argv(args)


def _evaluate_argv(args, cfg, root):
    argv = ["evaluate",
            "--n-test-sims", str(cfg.n_test_sims),
            "--particles", str(cfg.particles),
            "--steps", str(cfg.steps)]
    if args.finetune_rollout:
        argv += ["-m", "./models/best_rollout_model.pt"]
    elif args.rollout_select:
        argv += ["-m", "./models/selected_model.pt"]
    if args.f64_ground_truth:
        argv += ["--f64-ground-truth"]
    return argv + _watchdog_argv(args) + _device_argv(args)


def _require_dataset(args, root):
    # Windowed HDF5 datasets OR a --no-windows manifest (the --production
    # default; its trajectories HDF5 or npz) both satisfy the training
    # stage (train_model resolves the manifest itself).
    if args.skip_datagen and not any(
            (root / p).exists() for p in ("data/train_dataset.h5",
                                          "data/dataset_manifest.json")):
        sys.exit("Error: --skip-datagen specified but no training data found!")


PIPELINE = (
    Stage("Generating Training Data", _datagen_argv,
          skip=lambda a: "using existing data" if a.skip_datagen else None,
          precheck=_require_dataset),
    Stage("Training GNN Model", _train_argv,
          skip=lambda a: "using existing model" if a.skip_training else None),
    Stage("Selecting Checkpoint (rollout-aware)", _select_argv,
          skip=lambda a: None if a.rollout_select else "off by default "
          "(parity: the reference evaluates best-val; --rollout-select)"),
    Stage("Fine-tuning Rollout (K-step unrolled objective)", _finetune_argv,
          skip=lambda a: None if a.finetune_rollout else "off by default "
          "(parity: the reference has no rollout objective; "
          "--finetune-rollout)"),
    Stage("Evaluating AI vs HPC", _evaluate_argv),
    Stage("Exporting Results to CSV", lambda a, c, root: ["export_csv"]),
)


def with_values(stages, values: Dict[str, Dict[str, str]]):
    """``stages`` with listed argv values replaced: ``values`` maps a
    command to ``{flag: value}``; a flag the command's argv has gets the
    value, one it has not is appended.  How a caller cuts the depth of a
    run (the fine-tune curriculum, the width of a test) without a flag of
    the runner's own."""
    def wrap(build):
        def argv(args, cfg, root):
            out = build(args, cfg, root)
            for flag, value in values.get(out[0], {}).items():
                if flag in out:
                    out[out.index(flag) + 1] = value
                else:
                    out += [flag, value]
            return out
        return argv

    return tuple(dataclasses.replace(s, argv=wrap(s.argv)) for s in stages)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def banner(text: str) -> None:
    rule = "=" * 60
    print(f"\n{rule}\nSTEP: {text}\n{rule}")


def _stage_env() -> dict:
    """The stages' environment: this package importable from the workspace
    and unbuffered output, so each line shows as it is printed."""
    env = dict(os.environ)
    here = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH")) if p)
    env["PYTHONUNBUFFERED"] = "1"
    return env


def execute(stage: Stage, args: argparse.Namespace, cfg: TrainingConfig,
            root: Path) -> dict:
    """Run one stage in ``root``; its output is printed as it comes and
    kept in the returned record.  A failed stage ends the run."""
    stage.precheck(args, root)
    why_skip = stage.skip(args)
    if why_skip is not None:
        print(f"\n[Skipping {stage.title.lower()} - {why_skip}]")
        return {"title": stage.title, "skipped": why_skip}
    argv = stage.argv(args, cfg, root)
    cmd = [sys.executable, "-m", f"{PACKAGE}.{argv[0]}", *argv[1:]]
    banner(stage.title)
    print(f"Running: {' '.join(cmd)}\n", flush=True)
    t0 = time.time()
    lines = []
    with subprocess.Popen(cmd, cwd=root, env=_stage_env(), text=True,
                          stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT) as proc:
        for line in proc.stdout:
            print(line, end="", flush=True)
            lines.append(line)
    dt = time.time() - t0
    if proc.returncode != 0:
        print(f"\nError: {stage.title} failed with code {proc.returncode}")
        if proc.returncode == STALL_EXIT_CODE:
            print("The stage's stall watchdog fired (the device stalled?). "
                  "Once it recovers, rerun with --resume to continue from "
                  "the last checkpoint.")
        sys.exit(1)
    print(f"\nCompleted in {dt:.1f}s ({dt / 60:.1f} min)")
    return {"title": stage.title, "argv": argv,
            "returncode": proc.returncode, "seconds": dt,
            "output": "".join(lines)}


def print_header(cfg: TrainingConfig, device) -> None:
    import torch

    rule = "=" * 60
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "host CPU"
    rows = {
        "Particles": cfg.particles, "Simulations": cfg.simulations,
        "Steps": cfg.steps, "Hidden Dim": cfg.hidden_dim,
        "Layers": cfg.n_layers, "Dropout": cfg.dropout,
        "k-Neighbors": cfg.k_neighbors, "Batch Size": cfg.batch_size,
        "Noise Std": cfg.noise_std, "Weight Decay": cfg.weight_decay,
        "Device": f"{device} ({name})",
    }
    print(f"\n{rule}\nAI-HPC N-BODY GNN PIPELINE (PyTorch)\n{rule}")
    for label, value in rows.items():
        print(f"  {label + ':':<14}{value}")
    print(rule)


# Training-epoch budget of the measured production recipe (RESULTS.md:
# 60-epoch run, 49.4 s median epoch; best-val converged by epoch 42).
PRODUCTION_EPOCHS = 60
# Stall-watchdog default under --production (see resolve_mode).
PRODUCTION_WATCHDOG_S = 1800.0


def resolve_mode(args: argparse.Namespace) -> argparse.Namespace:
    """Expand --production / --reference-protocol into concrete flags.

    Mutates and returns ``args``: for every flag set of the JAX runner the
    same namespace as its ``resolve_mode``, with ``trajectory_format`` and
    ``device`` as given.  ``npz`` without ``--no-windows`` (which
    ``--production`` sets) is refused here, before any stage.
    """
    if args.production and args.reference_protocol:
        raise SystemExit(
            "Error: --production and --reference-protocol are mutually "
            "exclusive")
    if args.watchdog is not None and args.watchdog < 0:
        raise SystemExit(
            "Error: --watchdog must be positive (or 0 to disable)")
    if args.production:
        args.rollout_select = True
        if not args.no_finetune_rollout:
            # A production default since the JAX package's round 5, on
            # measurement: +9.0 min (12 % of the 73-min pipeline) for 93.35
            # -> 33.54 posRMSE (2.8x, f64 protocol), RESULTS.md. Opt out
            # with --no-finetune-rollout to evaluate the selected checkpoint.
            args.finetune_rollout = True
        args.no_windows = True
        args.f64_ground_truth = True
        if args.compression is None:
            args.compression = "lzf"
        if args.epochs is None:
            args.epochs = PRODUCTION_EPOCHS
        if args.watchdog is None:
            # Generous enough for the slowest stage step (a training epoch,
            # the kernel builds) yet bounded: a stalled device
            # mid-pipeline becomes a resumable failure, not a hang.
            args.watchdog = PRODUCTION_WATCHDOG_S
    if args.resume:
        # Resuming an interrupted run must not delete its artifacts:
        # datagen resumes at the file level, training from the newest
        # checkpoint (train_model --resume auto).
        args.no_clean = True
    if args.compression is None:
        args.compression = "gzip"  # reference-parity default
    if args.watchdog == 0:
        # Explicit disable, uniform across every command (maybe_watchdog
        # treats 0 the same way); 0 also suppressed the --production
        # default above (0 is not None).
        args.watchdog = None
    if args.trajectory_format == "npz" and not args.no_windows:
        raise SystemExit(
            "Error: --trajectory-format npz needs --no-windows (windowed "
            "datasets are HDF5); --production sets it")
    return args


def run_pipeline(args: argparse.Namespace, cfg: TrainingConfig, root,
                 stages=PIPELINE) -> List[dict]:
    """Run ``stages`` for the resolved ``args`` in the workspace ``root``:
    the header, the cleaning (unless ``args.no_clean``), then each stage
    (:func:`execute`).  The device is resolved first, so without a GPU and
    without ``--device cpu`` this raises before anything runs.  Returns
    one record a stage."""
    from nbody_gnn_hpc_torch.device import resolve_device

    device = resolve_device(args.device)  # raises without a card unasked
    args.device = str(device)
    root = Path(root)
    print_header(cfg, device)
    if not args.no_clean:
        clean_workspace(root, keep_data=args.skip_datagen)
    return [execute(stage, args, cfg, root) for stage in stages]


def build_parser():
    parser = argparse.ArgumentParser(
        description="Run full AI-HPC demo pipeline")
    parser.add_argument("--production", action="store_true",
                        help="Measured-best recipe in one switch: manifest "
                             "datagen + lzf, 60-epoch budget, f64 oracle, "
                             "rollout-aware checkpoint selection (best-val "
                             "selection is a measured 6x lottery) AND the "
                             "two-rung rollout fine-tune (RESULTS.md). Opt "
                             "out of the fine-tune with "
                             "--no-finetune-rollout")
    parser.add_argument("--no-finetune-rollout", action="store_true",
                        help="Under --production: skip the rollout "
                             "fine-tune stage and evaluate the selected "
                             "checkpoint instead. No-op otherwise")
    parser.add_argument("--reference-protocol", action="store_true",
                        help="Explicitly name the bare reference protocol "
                             "(the no-flag default): best-val checkpoint "
                             "selection, windowed gzip datagen, f32 "
                             "evaluation oracle")
    parser.add_argument("--skip-training", action="store_true",
                        help="Skip training (use existing model)")
    parser.add_argument("--skip-datagen", action="store_true",
                        help="Skip data generation (reuse existing data)")
    parser.add_argument("--no-clean", action="store_true",
                        help="Do not delete previous results")
    parser.add_argument("--resume", action="store_true",
                        help="Continue an interrupted run: keep existing "
                             "artifacts (implies --no-clean), resume datagen "
                             "at the file level and training from the newest "
                             "checkpoint to the same --epochs total. Pair "
                             "with the same mode flags as the original run")
    parser.add_argument("--watchdog", type=float, default=None,
                        metavar="SECONDS",
                        help="Stall watchdog for every device-driving stage "
                             "(datagen, training, selection, fine-tune, "
                             "evaluation): a stage exits with a distinctive "
                             "code if the device makes no progress for this "
                             "many seconds (default: off; 1800 under "
                             "--production; 0 disables explicitly). Rerun "
                             "with --resume after a stall")
    parser.add_argument("--max-samples", type=int, default=None,
                        help="Limit training samples (default: use all)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override training epochs (default: config)")
    parser.add_argument("--no-windows", action="store_true",
                        help="Datagen writes a manifest instead of windowed "
                             "HDF5 (training reads trajectories directly)")
    parser.add_argument("--compression", choices=("gzip", "lzf", "none"),
                        default=None,
                        help="HDF5 compression for datagen artifacts "
                             "(default: gzip; lzf under --production)")
    parser.add_argument("--f64-ground-truth", action="store_true",
                        help="Evaluate against the float64 reference-protocol "
                             "oracle (published-number protocol)")
    parser.add_argument("--rollout-select", action="store_true",
                        help="After training, pick the served checkpoint by "
                             "full-horizon rollout RMSE on val trajectories "
                             "(select_checkpoint) instead of best-val loss, "
                             "and evaluate that model")
    parser.add_argument("--finetune-rollout", action="store_true",
                        help="After training, fine-tune with the measured "
                             "two-rung K-step unrolled curriculum "
                             "(finetune_rollout) and evaluate "
                             "best_rollout_model.pt; takes precedence over "
                             "--rollout-select at evaluation. ON by default "
                             "under --production")
    parser.add_argument("--trajectory-format", choices=TRAJECTORY_FORMATS,
                        default="h5",
                        help="Datagen's trajectory files: h5 (the reference "
                             "schema, default) or npz (the same arrays, "
                             "written and read without h5py; needs "
                             "--no-windows, which --production sets)")
    parser.add_argument("--device", default=None,
                        help="torch device for every device-driving stage "
                             "(default cuda; 'cpu' only when asked for)")
    return parser


def main(argv=None) -> int:
    args = resolve_mode(build_parser().parse_args(argv))
    t0 = time.time()
    run_pipeline(args, TrainingConfig(), Path.cwd())
    dt = time.time() - t0
    rule = "=" * 60
    print(f"\n{rule}\nPIPELINE COMPLETE!\n{rule}")
    print(f"\nTotal time: {dt:.1f}s ({dt / 60:.1f} min)")
    print("\nOutputs:")
    print("  - data/       (training & validation datasets)")
    print("  - models/     (trained model & training history)")
    print("  - results/    (evaluation metrics & CSV tables)")
    print(rule)
    return 0


if __name__ == "__main__":
    sys.exit(main())
