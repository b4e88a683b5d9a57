"""Quickstart: train a tiny GNN surrogate end to end in one command (port
of ``examples/demo_surrogate.py``).

    python -m nbody_gnn_hpc_torch.examples.demo_surrogate [--sims 6]
        [--particles 24] [--steps 80] [--epochs 5]
        [--trajectory-format h5|npz]
    ... --device cpu   # the CPU, asked for

Simulates an ensemble on the device (the ensemble force kernel on the
card), saves each system to the trajectory store in a fresh temporary
directory (printed first, left in place as the JAX demo leaves it), builds
the 80/20 datasets, trains a small model (hidden 32, 2 layers, k=6; the
edge-stream kernels on the card) and rolls it out against a fresh ground
truth from seed 9999, from step 5.

``--trajectory-format h5`` (the default, as ``generate_data``'s) writes the
windowed HDF5 datasets with ``create_training_dataset`` and reads them with
``GNNDataset``, as the JAX demo does; both need h5py.  ``npz`` writes the
npz store and builds the same arrays with ``GNNDataset.from_trajectories``,
for a machine without h5py.  The kernel launches are printed last.
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

from nbody_gnn_hpc_torch.io.checkpoint import TRAJECTORY_FORMATS

SEQUENCE_LENGTH = 5
K_NEIGHBORS = 6


def simulate(seeds, n_particles: int, n_steps: int, device):
    """The demo's shared masses (seed 42) and the ensemble of ``seeds``
    with them, box 10, dt 0.001."""
    from nbody_gnn_hpc_torch.parallel import simulate_ensemble
    from nbody_gnn_hpc_torch.sim import shared_masses

    masses = shared_masses(n_particles, seed=42)
    traj = simulate_ensemble(
        seeds=list(seeds), n_particles=n_particles, n_steps=n_steps,
        box_size=10.0, dt=0.001, shared_masses=masses, device=device)
    return masses, traj


def store_and_split(traj, masses, workdir: Path, trajectory_format: str):
    """Save each system to ``workdir/checkpoints`` in ``trajectory_format``,
    read them back and build the training and validation datasets (the
    first 80 % of the systems train, the validation set takes the training
    statistics)."""
    from nbody_gnn_hpc_torch.io import (CheckpointManager,
                                        create_training_dataset)
    from nbody_gnn_hpc_torch.parallel import trajectory_slice
    from nbody_gnn_hpc_torch.train import GNNDataset

    manager = CheckpointManager(str(workdir / "checkpoints"))
    n_sims = traj.positions.shape[0]
    trajs = []
    for i in range(n_sims):
        manager.save_trajectory(trajectory_slice(traj, i), f"sim_{i:04d}",
                                trajectory_format=trajectory_format)
        trajs.append(manager.load_trajectory(f"sim_{i:04d}"))

    n_train = max(1, int(0.8 * n_sims))
    kw = dict(k_neighbors=K_NEIGHBORS)
    if trajectory_format == "h5":
        for part, name in ((trajs[:n_train], "train.h5"),
                           (trajs[n_train:], "val.h5")):
            create_training_dataset(part, str(workdir / name),
                                    sequence_length=SEQUENCE_LENGTH,
                                    masses=masses)
        ds_train = GNNDataset(str(workdir / "train.h5"), **kw)
        ds_val = GNNDataset(str(workdir / "val.h5"), external_norm_stats=
                            ds_train.get_normalization_stats(), **kw)
    else:
        kw["sequence_length"] = SEQUENCE_LENGTH
        ds_train = GNNDataset.from_trajectories(trajs[:n_train], **kw)
        ds_val = GNNDataset.from_trajectories(
            trajs[n_train:], external_norm_stats=
            ds_train.get_normalization_stats(), **kw)
    return ds_train, ds_val


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sims", type=int, default=6)
    parser.add_argument("--particles", type=int, default=24)
    parser.add_argument("--steps", type=int, default=80)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--trajectory-format", choices=TRAJECTORY_FORMATS,
                        default="h5",
                        help="h5: windowed HDF5 datasets (needs h5py); npz: "
                             "the npz store and datasets built from it")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    args = parser.parse_args(argv)

    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.ops import launch_line
    from nbody_gnn_hpc_torch.predict import Predictor, compare_with_hpc
    from nbody_gnn_hpc_torch.train import Trainer

    dev = resolve_device(args.device)
    workdir = Path(tempfile.mkdtemp(prefix="nbody_demo_"))
    print(f"workdir: {workdir}")

    # 1. Data generation: one batched device program for all sims.
    masses, traj = simulate(range(42, 42 + args.sims), args.particles,
                            args.steps, dev)
    ds_train, ds_val = store_and_split(traj, masses, workdir,
                                       args.trajectory_format)

    # 2. Training.
    model = NBodyGNN(node_input_dim=7, hidden_dim=32, n_layers=2,
                     output_dim=6, dropout=0.1)
    trainer = Trainer(model, ds_train, ds_val,
                      model_dir=str(workdir / "models"), batch_size=16,
                      device=dev)
    trainer.train(n_epochs=args.epochs, verbose=True)

    # 3. Rollout vs fresh ground truth.
    predictor = Predictor(model, str(workdir / "models" / "best_model.pt"),
                          device=dev, k_neighbors=K_NEIGHBORS)
    _, test = simulate([9999], args.particles, args.steps, dev)
    result = compare_with_hpc(
        predictor,
        {"positions": test.positions[0].cpu().numpy().astype(np.float64),
         "velocities": test.velocities[0].cpu().numpy().astype(np.float64),
         "masses": masses},
        start_step=5, n_prediction_steps=args.steps - 6)
    print(f"\nRollout vs HPC over {args.steps - 6} steps:")
    print(f"  mean position RMSE: {result['mean_position_rmse']:.4e}")
    print(f"  final position RMSE: {result['final_position_rmse']:.4e}")
    print(launch_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
