"""Train the N-body GNN on the GPU (port of ``scripts/train_model.py``).

    python -m nbody_gnn_hpc_torch.train_model --data-dir data --epochs 200
    python -m nbody_gnn_hpc_torch.train_model --device cpu ...   # CPU, asked

The same flags as the JAX CLI (minus its TPU-only ones), the same config
override pattern, ``config.json`` written to the model directory for
evaluation and serving, and the val set normalised with the train set's
statistics (reference ``train_model.py:94-100``).  Reads the windowed
``train_dataset.h5`` / ``val_dataset.h5`` or, where a ``--no-windows``
datagen left only ``dataset_manifest.json``, the trajectory files it names.
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
    parser.add_argument("--resume", type=str, default=None, metavar="CKPT",
                        help="Resume from a checkpoint file in --model-dir, "
                             "training --epochs MORE epochs; 'auto' picks "
                             "the checkpoint with the highest epoch and "
                             "trains the REMAINING epochs up to --epochs")
    parser.add_argument("--edge-impl", choices=("fused", "fused_full"),
                        default="fused",
                        help="how an interaction layer runs: the edge "
                             "stream as a kernel between PyTorch's "
                             "projections and node MLP, or the whole layer "
                             "as one kernel (same parameters; written to "
                             "config.json)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from nbody_gnn_hpc_torch.config import TrainingConfig
    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.io.model_io import latest_checkpoint
    from nbody_gnn_hpc_torch.models import count_parameters, model_from_config
    from nbody_gnn_hpc_torch.train import (MANIFEST_NAME, GNNDataset, Trainer,
                                           datasets_from_manifest)

    config = TrainingConfig()
    for flag, _, _ in CONFIG_FLAGS:
        field = flag.lstrip("-").replace("-", "_")
        override = getattr(args, field)
        if override is not None:
            setattr(config, field, override)

    device = resolve_device(args.device)  # raises without a card unasked
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

    print("=" * 60)
    print("N-BODY GNN TRAINING (PyTorch)")
    print("=" * 60)
    for label, v in (("Device", device), ("Epochs", config.epochs),
                     ("Batch Size", config.batch_size),
                     ("Learning Rate", config.learning_rate),
                     ("Hidden Dim", config.hidden_dim),
                     ("Layers", config.n_layers),
                     ("k-Neighbors", config.k_neighbors),
                     ("Dropout", config.dropout),
                     ("Weight Decay", config.weight_decay),
                     ("Noise Std", config.noise_std),
                     ("Physics Loss", args.physics_loss)):
        print(f"  {label + ':':<16} {v}")
    print("=" * 60)

    print("\nLoading datasets...")
    if use_manifest:
        # --no-windows datagen: the (state, target) pairs straight from the
        # trajectory files, by the window protocol the manifest records.
        print(f"  (trajectory-direct path via {manifest_path.name})")
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
        print(f"Subsampling: {len(train_dataset)} -> {args.max_samples}")
        train_dataset.last_states = train_dataset.last_states[:args.max_samples]
        train_dataset.targets = train_dataset.targets[:args.max_samples]
        train_dataset.n_samples = args.max_samples

    # The JAX CLI's schema; the port trains and serves in float32.
    model_config = {
        "node_input_dim": 7,
        "hidden_dim": config.hidden_dim,
        "n_layers": config.n_layers,
        "output_dim": 6,
        "dropout": config.dropout,
        "dtype": "float32",
        "edge_impl": args.edge_impl,
    }
    print(f"\n  Train samples: {len(train_dataset)}")
    if val_dataset:
        print(f"  Val samples:   {len(val_dataset)}")
    model = model_from_config(model_config)
    with open(model_dir / "config.json", "w") as f:
        json.dump({"model_type": "gnn", "model_config": model_config,
                   "training_config": config.to_dict()}, f, indent=2,
                  default=str)

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
    )
    print(f"  Parameters:    {count_parameters(trainer.model):,}")

    n_epochs = config.epochs
    resume_name = args.resume
    if resume_name == "auto":
        resume_name = latest_checkpoint(model_dir)
        if resume_name is None:
            print("  --resume auto: no checkpoint found; starting fresh")
    if resume_name:
        trainer.load_model(resume_name)
        print(f"  Resumed from:  {model_dir / resume_name} "
              f"(epoch {trainer.current_epoch}, "
              f"best val {trainer.best_val_loss:.6f})")
        if args.resume == "auto":
            # Crash recovery continues to the same total budget; an explicit
            # --resume CKPT trains --epochs more.
            n_epochs = remaining_epochs_auto(config.epochs,
                                             trainer.current_epoch, model_dir)
            print(f"  Remaining:     {n_epochs} of {config.epochs} epochs")

    print("\nStarting training...")
    history = trainer.train(n_epochs=n_epochs,
                            early_stopping_patience=config.early_stopping,
                            save_every=10)

    print("\n" + "=" * 60)
    print("TRAINING COMPLETE")
    print("=" * 60)
    print(f"  Best Val Loss:    {trainer.best_val_loss:.6f}")
    if history["train_loss"]:
        print(f"  Final Train Loss: {history['train_loss'][-1]:.6f}")
    print(f"  Model saved to:   {model_dir}")
    print("=" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
