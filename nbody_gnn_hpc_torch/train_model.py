"""Train the N-body GNN on the GPU (port of ``scripts/train_model.py``).

    python -m nbody_gnn_hpc_torch.train_model --data-dir data --epochs 200
    python -m nbody_gnn_hpc_torch.train_model --device cpu ...   # CPU, asked
    torchrun --nproc-per-node 4 -m nbody_gnn_hpc_torch.train_model \
        --data-parallel ...                        # one rank a GPU

The same flags as the JAX CLI, the same config override pattern,
``config.json`` written to the model directory for evaluation and serving,
and the val set normalised with the train set's statistics (reference
``train_model.py:94-100``).  On the GPU the model trains as the JAX CLI
trains on its accelerator: bf16 products (the tensor cores) and the bf16
edge stream (with ``--edge-impl fused_full``, the whole-layer kernel's bf16
form), float32 parameters, ``"dtype": "bfloat16"`` in ``config.json``;
``--no-bf16`` trains in float32, as does ``--device cpu``.
Evaluation and serving rebuild the model at float32 from the same
checkpoint.  ``--remat`` recomputes each interaction layer in the backward
pass.  Reads the windowed
``train_dataset.h5`` / ``val_dataset.h5`` or, where a ``--no-windows``
datagen left only ``dataset_manifest.json``, the trajectory files it names.

``--data-parallel`` joins the process group that torchrun describes (one
rank a GPU, NCCL; gloo with ``--device cpu``), or forms a world of one on
the chosen device without torchrun, and trains with each batch split over
the ranks (``Trainer(mesh=)``); only rank 0 writes files and the run's log.
``--ckpt-backend orbax`` writes the checkpoints as async writes
(``Trainer(ckpt_backend="orbax")``) and ``--resume auto`` then picks among
the durable ones.  Where matplotlib imports, ``plots/training_history.png``
is drawn into the model directory.  Every rank prints its own kernel
launches last.
"""

import argparse
import json
import sys
from pathlib import Path

# Flags that override the TrainingConfig field of the same name when given:
# (long flag, short flag or None, type).
CONFIG_FLAGS = (
    ("--epochs", "-e", int),
    ("--batch-size", "-b", int),
    ("--learning-rate", "-lr", float),
    ("--hidden-dim", None, int),
    ("--n-layers", None, int),
    ("--early-stopping", None, int),
    ("--workers", "-w", int),
    ("--dropout", None, float),
    ("--noise-std", None, float),
    ("--weight-decay", None, float),
    ("--k-neighbors", None, int),
)


def remaining_epochs_auto(budget: int, current_epoch: int,
                          model_dir: Path) -> int:
    """Epochs left for ``--resume auto``: none after a run that stopped
    early (``early_stopped`` in training_history.json), else up to the
    budget."""
    remaining = max(0, budget - current_epoch)
    if remaining == 0:
        return 0
    try:
        with open(Path(model_dir) / "training_history.json") as f:
            early_stopped = bool(json.load(f).get("early_stopped", False))
    except (OSError, ValueError):
        early_stopped = False
    if early_stopped:
        print(f"  --resume auto: previous run finished by early stopping "
              f"at epoch {current_epoch} — nothing to retrain")
        return 0
    return remaining


def build_parser():
    parser = argparse.ArgumentParser(description="Train N-Body GNN Model")
    for flag, short, typ in CONFIG_FLAGS:
        names = (flag, short) if short else (flag,)
        parser.add_argument(*names, type=typ, default=None)
    parser.add_argument("--data-dir", "-d", type=str, default="./data")
    parser.add_argument("--model-dir", "-o", type=str, default="./models")
    parser.add_argument("--physics-loss", action="store_true", default=True)
    parser.add_argument("--max-samples", type=int, default=None,
                        help="Limit training samples (default: use all)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Split each batch over the ranks of the "
                             "process group torchrun describes (a world of "
                             "one without torchrun); parameters replicated")
    parser.add_argument("--resume", type=str, default=None, metavar="CKPT",
                        help="Resume from a checkpoint file in --model-dir, "
                             "training --epochs MORE epochs; 'auto' picks "
                             "the checkpoint with the highest epoch and "
                             "trains the REMAINING epochs up to --epochs")
    parser.add_argument("--no-bf16", action="store_true",
                        help="Train matmuls in float32 instead of bfloat16")
    parser.add_argument("--remat", action="store_true",
                        help="Rematerialize interaction layers in backward "
                             "(lower memory, ~35%% slower)")
    parser.add_argument("--edge-impl", choices=("fused", "fused_full"),
                        default="fused",
                        help="how an interaction layer runs: the edge "
                             "stream as a kernel between PyTorch's "
                             "projections and node MLP, or the whole layer "
                             "as one kernel (same parameters; written to "
                             "config.json)")
    parser.add_argument("--ckpt-backend", choices=("pickle", "orbax"),
                        default="pickle",
                        help="Checkpoint backend: pickle .pt files (the "
                             "JAX package's, synchronous) or orbax (async "
                             "background writes in "
                             "torch.distributed.checkpoint's format under "
                             "<model-dir>/orbax, metadata in "
                             "orbax_index.json)")
    parser.add_argument("--watchdog", type=float, default=None,
                        metavar="SECONDS",
                        help="Exit with a distinctive code if no epoch's "
                             "losses reach the host for this many seconds "
                             "(stall detection; rerun with --resume auto "
                             "to continue). Must cover the slowest epoch "
                             "and the first one's kernel builds. "
                             "0 disables.")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.data_parallel:
        return _train(args)
    import torch.distributed as dist

    from nbody_gnn_hpc_torch.parallel.mesh import init_data_parallel

    created = not dist.is_initialized()
    device = init_data_parallel(args.device)  # raises without a card unasked
    try:
        return _train(args, device)
    finally:
        if created:
            dist.destroy_process_group()


def _train(args, device=None) -> int:
    from nbody_gnn_hpc_torch.config import TrainingConfig
    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.io.model_io import latest_checkpoint
    from nbody_gnn_hpc_torch.models import (count_parameters,
                                            model_from_config)
    from nbody_gnn_hpc_torch.ops import launch_line
    from nbody_gnn_hpc_torch.train import (MANIFEST_NAME, GNNDataset, Trainer,
                                           datasets_from_manifest)

    config = TrainingConfig()
    for flag, _, _ in CONFIG_FLAGS:
        field = flag.lstrip("-").replace("-", "_")
        override = getattr(args, field)
        if override is not None:
            setattr(config, field, override)

    mesh = None
    say = print
    if device is None:
        device = resolve_device(args.device)  # raises without a card unasked
    else:
        import torch.distributed as dist

        from nbody_gnn_hpc_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
        if dist.get_rank() != 0:  # the log is rank 0's
            def say(*_, **__):
                return None
    # bf16 products on the card (the JAX CLI's on its accelerator), float32
    # off it or when asked.
    dtype = ("float32" if args.no_bf16 or device.type != "cuda"
             else "bfloat16")
    data_dir = Path(args.data_dir)
    model_dir = Path(args.model_dir)
    train_path = data_dir / "train_dataset.h5"
    val_path = data_dir / "val_dataset.h5"
    manifest_path = data_dir / MANIFEST_NAME
    use_manifest = not train_path.exists() and manifest_path.exists()
    if not train_path.exists() and not use_manifest:
        print(f"Error: Training data not found at {train_path} "
              f"(and no {manifest_path.name})")
        print("Run generate_data.py first!")
        return 1
    model_dir.mkdir(parents=True, exist_ok=True)

    say("=" * 60)
    say("N-BODY GNN TRAINING (PyTorch)")
    say("=" * 60)
    for label, v in (("Device", device), ("Epochs", config.epochs),
                     ("Batch Size", config.batch_size),
                     ("Learning Rate", config.learning_rate),
                     ("Hidden Dim", config.hidden_dim),
                     ("Layers", config.n_layers),
                     ("k-Neighbors", config.k_neighbors),
                     ("Dropout", config.dropout),
                     ("Weight Decay", config.weight_decay),
                     ("Noise Std", config.noise_std),
                     ("Compute Dtype", dtype),
                     ("Remat", args.remat),
                     ("Physics Loss", args.physics_loss)):
        say(f"  {label + ':':<16} {v}")
    say("=" * 60)

    say("\nLoading datasets...")
    if use_manifest:
        # --no-windows datagen: the (state, target) pairs straight from the
        # trajectory files, by the window protocol the manifest records.
        say(f"  (trajectory-direct path via {manifest_path.name})")
        train_dataset, val_dataset = datasets_from_manifest(
            manifest_path, k_neighbors=config.k_neighbors)
    else:
        train_dataset = GNNDataset(str(train_path),
                                   sequence_length=config.sequence_length,
                                   k_neighbors=config.k_neighbors)
        val_dataset = GNNDataset(
            str(val_path), sequence_length=config.sequence_length,
            k_neighbors=config.k_neighbors,
            external_norm_stats=train_dataset.get_normalization_stats()
        ) if val_path.exists() else None

    if args.max_samples and len(train_dataset) > args.max_samples:
        say(f"Subsampling: {len(train_dataset)} -> {args.max_samples}")
        train_dataset.last_states = train_dataset.last_states[:args.max_samples]
        train_dataset.targets = train_dataset.targets[:args.max_samples]
        train_dataset.n_samples = args.max_samples

    # The JAX CLI's schema: training runs in ``dtype`` (parameters float32
    # either way); inference rebuilds the model at float32.
    model_config = {
        "node_input_dim": 7,
        "hidden_dim": config.hidden_dim,
        "n_layers": config.n_layers,
        "output_dim": 6,
        "dropout": config.dropout,
        "dtype": dtype,
        "remat": args.remat,
        "edge_impl": args.edge_impl,
    }
    say(f"\n  Train samples: {len(train_dataset)}")
    if val_dataset:
        say(f"  Val samples:   {len(val_dataset)}")
    model = model_from_config(model_config)
    if say is print:
        with open(model_dir / "config.json", "w") as f:
            json.dump({"model_type": "gnn", "model_config": model_config,
                       "training_config": config.to_dict()}, f, indent=2,
                      default=str)
    if mesh is not None:
        say(f"  Data parallel:  {dist.get_world_size()} ranks "
            f"({dist.get_backend()})")

    trainer = Trainer(
        model=model,
        train_dataset=train_dataset,
        val_dataset=val_dataset,
        model_dir=str(model_dir),
        device=device,
        learning_rate=config.learning_rate,
        batch_size=config.batch_size,
        use_physics_loss=args.physics_loss,
        num_workers=config.workers,
        weight_decay=config.weight_decay,
        noise_std=config.noise_std,
        n_epochs=config.epochs,
        mesh=mesh,
        ckpt_backend=args.ckpt_backend,
    )
    say(f"  Parameters:    {count_parameters(trainer.model):,}")

    n_epochs = config.epochs
    resume_name = args.resume
    if resume_name == "auto":
        resume_name = latest_checkpoint(model_dir, backend=args.ckpt_backend)
        if resume_name is None:
            say("  --resume auto: no checkpoint found; starting fresh")
    if resume_name:
        trainer.load_model(resume_name)
        say(f"  Resumed from:  {model_dir / resume_name} "
              f"(epoch {trainer.current_epoch}, "
              f"best val {trainer.best_val_loss:.6f})")
        if args.resume == "auto":
            # Crash recovery continues to the same total budget; an explicit
            # --resume CKPT trains --epochs more.
            n_epochs = remaining_epochs_auto(config.epochs,
                                             trainer.current_epoch, model_dir)
            say(f"  Remaining:     {n_epochs} of {config.epochs} epochs")

    say("\nStarting training...")
    history = trainer.train(n_epochs=n_epochs,
                            early_stopping_patience=config.early_stopping,
                            save_every=10, watchdog_s=args.watchdog)

    say("\n" + "=" * 60)
    say("TRAINING COMPLETE")
    say("=" * 60)
    say(f"  Best Val Loss:    {trainer.best_val_loss:.6f}")
    if history["train_loss"]:
        say(f"  Final Train Loss: {history['train_loss'][-1]:.6f}")
    say(f"  Model saved to:   {model_dir}")
    say("=" * 60)
    if say is print:  # plotting is best effort, as in the JAX CLI
        try:
            from nbody_gnn_hpc_torch.utils import Visualizer

            viz = Visualizer(str(model_dir / "plots"))
        except ImportError as e:
            print(f"  (Could not create plot: {e})")
        else:
            viz.plot_training_history(history,
                                      save_name="training_history.png",
                                      show=False)
            print(f"  Training plot:    "
                  f"{model_dir / 'plots' / 'training_history.png'}")
    print(launch_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
