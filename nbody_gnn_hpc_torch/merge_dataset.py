"""Merge trajectory files into windowed training datasets, one file at a
time (port of ``scripts/merge_dataset.py``; reference
``scripts/merge_dataset.py``).

    python -m nbody_gnn_hpc_torch.merge_dataset [-o ./data]
        [--sequence-length 10] [--test-size 0.2]

Reads ``<output-dir>/checkpoints`` and writes ``train_dataset.h5`` and, when
the split leaves files for it, ``val_dataset.h5`` beside it, in the
training-dataset schema of ``io/checkpoint.py`` (float32 ``inputs (S, L, N,
6)`` and ``targets (S, N, 6)``, gzip 4, chunks of ``min(100, S)`` samples,
``masses``, the ``n_samples`` and ``sequence_length`` attributes).

The JAX script's three fixes of the reference are kept: the masses are
written, the 80/20 split is made, and each file's samples are counted
exactly before anything is written.  It reads both trajectory stores
(``sim_XXXX_trajectory.h5`` and the npz form,
:meth:`~nbody_gnn_hpc_torch.io.checkpoint.CheckpointManager.load_trajectory`):
the one departure from the JAX script, which globs HDF5 files only.  The
datasets are HDF5, so writing them needs h5py.  The command does no tensor
work and has no ``--device``; it prints the kernel launches (none) last.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

from nbody_gnn_hpc_torch.io.checkpoint import CheckpointManager


def write_split(manager: CheckpointManager, names, output_path,
                seq_len: int, stride: int = 1) -> int:
    """Stream the trajectories ``names`` of ``manager`` into one windowed
    dataset at ``output_path``; returns its sample count (0: nothing
    written)."""
    # First pass: exact sample counts and the particle count and masses of
    # the first file.
    counts, n_particles, masses = [], None, None
    for name in names:
        traj = manager.load_trajectory(name)
        n_steps = int(traj["n_steps"])
        if n_particles is None:
            n_particles = traj["positions"].shape[1]
            masses = traj["masses"]
        if traj["positions"].shape[1] != n_particles:
            print(f"Skipping {manager.trajectory_path(name)}: mismatch in "
                  f"particle count")
            counts.append(0)
            continue
        counts.append(-(-(n_steps - seq_len) // stride)
                      if n_steps > seq_len else 0)
        del traj
    total = sum(counts)
    if total == 0:
        print(f"No samples for {output_path}; skipping")
        return 0

    import h5py

    in_shape = (seq_len, n_particles, 6)
    tgt_shape = (n_particles, 6)
    with h5py.File(output_path, "w") as out:
        inputs_ds = out.create_dataset(
            "inputs", shape=(total,) + in_shape, dtype="float32",
            compression="gzip", compression_opts=4,
            chunks=(min(100, total),) + in_shape)
        targets_ds = out.create_dataset(
            "targets", shape=(total,) + tgt_shape, dtype="float32",
            compression="gzip", compression_opts=4,
            chunks=(min(100, total),) + tgt_shape)

        idx = 0
        for name, n_samples in zip(names, counts):
            if n_samples == 0:
                continue
            traj = manager.load_trajectory(name)
            state = np.concatenate([traj["positions"], traj["velocities"]],
                                   axis=-1).astype(np.float32)
            del traj
            starts = np.arange(0, state.shape[0] - seq_len, stride)
            windows = state[starts[:, None] + np.arange(seq_len)[None, :]]
            inputs_ds[idx:idx + n_samples] = windows
            targets_ds[idx:idx + n_samples] = state[starts + seq_len]
            idx += n_samples
            del state, windows

        out.attrs["n_samples"] = total
        out.attrs["sequence_length"] = seq_len
        out.create_dataset("masses", data=np.asarray(masses, np.float32))
    print(f"  {output_path}: {total} samples from {len(names)} files")
    return total


def build_parser():
    parser = argparse.ArgumentParser(description="Merge trajectories safely")
    parser.add_argument("--output-dir", "-o", type=str, default="./data",
                        help="Output directory containing checkpoints folder")
    parser.add_argument("--sequence-length", type=int, default=10,
                        help="Sequence length")
    parser.add_argument("--test-size", type=float, default=0.2,
                        help="Validation fraction (80/20 default split)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from nbody_gnn_hpc_torch.ops import launch_line

    output_dir = Path(args.output_dir)
    checkpoint_dir = output_dir / "checkpoints"
    if not checkpoint_dir.exists():
        print(f"Error: Checkpoint directory not found at {checkpoint_dir}")
        return 1

    manager = CheckpointManager(str(checkpoint_dir))
    names = manager.trajectory_names()
    print(f"Found {len(names)} trajectory files.")
    if not names:
        print("No files to merge.")
        print(launch_line())
        return 0

    n_train = int((1.0 - args.test_size) * len(names))
    n_train = max(1, min(n_train, len(names)))

    print("Creating train/val datasets...")
    write_split(manager, names[:n_train], output_dir / "train_dataset.h5",
                args.sequence_length)
    if n_train < len(names):
        write_split(manager, names[n_train:], output_dir / "val_dataset.h5",
                    args.sequence_length)

    print("Merge complete.")
    print(launch_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
