"""Generate training data for the N-body GNN on the GPU (port of
``scripts/generate_data.py``).

    python -m nbody_gnn_hpc_torch.generate_data --particles 200 \\
        --simulations 300 --steps 400
    python -m nbody_gnn_hpc_torch.generate_data --device cpu ...  # CPU, asked

The reference CLI's flags and protocol: shared masses from ``--seed``,
per-sim seeds ``seed + i``, dt fixed at 0.001, resumable through the
trajectory files already written, 80/20 train/val split.  Each batch of
simulations integrates as one ensemble on the device
(:func:`nbody_gnn_hpc_torch.parallel.simulate_ensemble`); a single writer
thread writes batch k's HDF5 files while the main thread reads batch k+1
back.  Writing needs ``h5py``.
"""

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def build_parser():
    parser = argparse.ArgumentParser(
        description="Generate N-body training data",
        epilog="The JAX CLI's --watchdog (stall detection for a remote "
               "backend) is not ported; rerunning the command resumes at "
               "the file level.  Its --workers has no counterpart: the "
               "simulations run on the device, not in worker processes.")
    parser.add_argument("--particles", "-n", type=int, default=500,
                        help="Number of particles per simulation")
    parser.add_argument("--simulations", "-s", type=int, default=50,
                        help="Number of simulations to run")
    parser.add_argument("--steps", type=int, default=200,
                        help="Timesteps per simulation")
    parser.add_argument("--save-interval", type=int, default=1,
                        help="Save state every N steps")
    parser.add_argument("--box-size", type=float, default=10.0,
                        help="Simulation box size")
    parser.add_argument("--output-dir", "-o", type=str, default="./data",
                        help="Output directory")
    parser.add_argument("--sequence-length", type=int, default=5,
                        help="Sequence length for training samples")
    parser.add_argument("--seed", type=int, default=42,
                        help="Random seed base")
    parser.add_argument("--batch-size", type=int, default=100,
                        help="Simulations per device batch (memory control)")
    parser.add_argument("--gzip-level", type=int, default=4,
                        help="HDF5 gzip level for windowed datasets "
                             "(4 = reference default; 1 writes faster)")
    parser.add_argument("--compression", choices=("gzip", "lzf", "none"),
                        default="gzip",
                        help="HDF5 codec for all written files (gzip = "
                             "reference schema default; lzf and none write "
                             "faster). Readers are codec-agnostic.")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="Device batches dispatched ahead of host "
                             "writes (device memory permitting)")
    parser.add_argument("--no-windows", action="store_true",
                        help="Skip the windowed train/val HDF5 files (each "
                             "state is stored ~seq-len times over). Writes "
                             "dataset_manifest.json instead; train_model "
                             "builds the (state, target) pairs directly "
                             "from the trajectory files at load time.")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.io import (CheckpointManager,
                                        create_training_dataset)
    from nbody_gnn_hpc_torch.parallel import (fetch_host_trajectory,
                                              simulate_ensemble,
                                              trajectory_slice)
    from nbody_gnn_hpc_torch.sim import shared_masses as make_shared_masses
    from nbody_gnn_hpc_torch.train import write_manifest
    from nbody_gnn_hpc_torch.utils import StageTimer

    device = resolve_device(args.device)  # raises without a card unasked
    output_dir = Path(args.output_dir)
    checkpoint_dir = output_dir / "checkpoints"
    checkpoint_dir.mkdir(parents=True, exist_ok=True)

    print("=" * 60)
    print("N-BODY DATA GENERATION (PyTorch)")
    print("=" * 60)
    print(f"  Particles:     {args.particles}")
    print(f"  Simulations:   {args.simulations}")
    print(f"  Steps:         {args.steps}")
    print(f"  Device:        {device}")
    print(f"  Output Dir:    {output_dir}")
    print("=" * 60)

    manager = CheckpointManager(str(checkpoint_dir))
    timer = StageTimer()

    # Shared masses: all sims use the same particle masses so the physics
    # loss is exact (reference generate_data.py:106-110).
    shared_masses = make_shared_masses(args.particles, seed=args.seed)
    print(f"  Shared masses: range [{shared_masses.min():.2e}, "
          f"{shared_masses.max():.2e}]")

    n_batches = -(-args.simulations // args.batch_size)
    print(f"\nProcessing {args.simulations} simulations in {n_batches} "
          f"batches (prefetch depth {args.prefetch})...")

    # Which sims each batch still owes (file-level resume, reference
    # generate_data.py:129-130).
    work = []
    total_skipped = 0
    for start in range(0, args.simulations, args.batch_size):
        end = min(start + args.batch_size, args.simulations)
        todo = [i for i in range(start, end)
                if not manager.trajectory_exists(f"sim_{i:04d}")]
        total_skipped += (end - start) - len(todo)
        if todo:
            work.append(todo)

    def dispatch(todo):
        """Enqueue one batch on the device; the tensors of the returned
        trajectory are ready once the device has run the queue."""
        return simulate_ensemble(
            seeds=[args.seed + i for i in todo],
            n_particles=args.particles, n_steps=args.steps,
            box_size=args.box_size,
            dt=0.001,  # pipeline value (the reference hardcodes it too)
            save_interval=args.save_interval, shared_masses=shared_masses,
            device=device)

    in_memory = {}  # sim_idx -> trajectory dict, avoids disk round-trips

    def save_batch(todo, traj):
        # Runs on the writer thread and mutates `in_memory` and the "save"
        # entry of the StageTimer: race-free only under the single-writer
        # invariant (max_workers=1 below); the main thread reads both only
        # after every write has been waited for, and times other stages.
        with timer.stage("save"):
            for j, sim_idx in enumerate(todo):
                sl = trajectory_slice(traj, j)
                manager.save_trajectory(
                    sl, f"sim_{sim_idx:04d}",
                    metadata={"n_particles": args.particles,
                              "seed": args.seed + sim_idx},
                    compression=args.compression)
                in_memory[sim_idx] = {
                    "positions": sl.positions, "velocities": sl.velocities,
                    "masses": sl.masses, "n_steps": sl.positions.shape[0]}

    # One writer thread only: each trajectory is its own HDF5 file, and a
    # single writer keeps h5py single-threaded.  Reading the result of
    # every write re-raises a writer failure here: a failed or partial
    # trajectory write must not pass silently, since resume trusts what
    # landed on disk.
    inflight = []   # (todo, device trajectory)
    pending = None  # the writer thread's future of the previous batch
    next_dispatch = 0
    done_sims = 0
    t_wall = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as writer:
        while inflight or next_dispatch < len(work):
            while (next_dispatch < len(work)
                   and len(inflight) < max(1, args.prefetch)):
                with timer.stage("dispatch"):
                    inflight.append((work[next_dispatch],
                                     dispatch(work[next_dispatch])))
                next_dispatch += 1
            todo, device_traj = inflight.pop(0)
            with timer.stage("fetch"):
                traj = fetch_host_trajectory(device_traj)
            del device_traj
            done_sims += len(todo)
            print(f"  Simulated {done_sims} new sims "
                  f"(+{total_skipped} resumed); writing...")
            if pending is not None:
                pending.result()
            pending = writer.submit(save_batch, todo, traj)
        if pending is not None:
            pending.result()
    wall = time.perf_counter() - t_wall
    if total_skipped:
        print(f"  Already complete: skipped {total_skipped} sims")
    if done_sims:
        print(f"  {done_sims} sims x {args.steps} steps in {wall:.2f} s "
              f"(simulate + read back + write): "
              f"{done_sims * args.steps / wall:,.0f} sim-steps/s")

    n_train = int(0.8 * args.simulations)

    if args.no_windows:
        sim_names = [f"sim_{i:04d}" for i in range(args.simulations)]
        manifest = write_manifest(output_dir, sim_names[:n_train],
                                  sim_names[n_train:],
                                  sequence_length=args.sequence_length)
        print("\n" + "=" * 60)
        print("DATA GENERATION COMPLETE (trajectory manifest mode)")
        print("=" * 60)
        print(f"  Manifest:      {manifest}")
        print(f"  Trajectories:  {checkpoint_dir}")
        print(timer.report())
        print("=" * 60)
        return 0

    # Fresh sims straight from memory, resumed sims from their files.
    all_trajectories = []
    with timer.stage("load"):
        for i in range(args.simulations):
            if i in in_memory:
                all_trajectories.append(in_memory[i])
            else:
                t = manager.load_trajectory(f"sim_{i:04d}")
                all_trajectories.append({
                    key: t[key] for key in ("positions", "velocities",
                                            "masses", "n_steps")})

    print(f"\nGenerated {len(all_trajectories)} trajectories")
    print("\nCreating training datasets...")
    masses = all_trajectories[0].get("masses")
    with timer.stage("dataset"):
        for name, trajs in (("train", all_trajectories[:n_train]),
                            ("val", all_trajectories[n_train:])):
            create_training_dataset(
                trajs, str(output_dir / f"{name}_dataset.h5"),
                sequence_length=args.sequence_length, stride=1,
                masses=masses, gzip_level=args.gzip_level,
                compression=args.compression)

    print("\n" + "=" * 60)
    print("DATA GENERATION COMPLETE")
    print("=" * 60)
    print(f"  Train dataset: {output_dir / 'train_dataset.h5'}")
    print(f"  Val dataset:   {output_dir / 'val_dataset.h5'}")
    print(timer.report())
    print("=" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
