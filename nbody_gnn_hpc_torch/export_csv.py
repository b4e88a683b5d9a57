"""Export evaluation results, a sample trajectory and the training history
to CSV (port of ``scripts/export_csv.py``).

    python -m nbody_gnn_hpc_torch.export_csv [-d DATA] [-m MODELS] \\
        [-r RESULTS] [-o OUT]

The same five tables as the JAX script, with the same file names, headers
and number format, each made by a function of its own and written by one
CSV writer.  The sample trajectory is read through the port's
:class:`~nbody_gnn_hpc_torch.io.CheckpointManager`, so it comes from an
HDF5 or an npz store; where the store is HDF5 and h5py does not import,
that table is skipped with a printed line, as the JAX script skips it.
Host work only: no device is used.
"""

import argparse
import csv
import json
import sys
from pathlib import Path

from nbody_gnn_hpc_torch.io.checkpoint import CheckpointManager


def sci(x):
    """Render floats in scientific notation, pass everything else through."""
    return f"{x:.6e}" if isinstance(x, float) else x


def write_table(out_dir: Path, filename: str, header, rows) -> Path:
    path = out_dir / filename
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(header)
        writer.writerows(rows)
    return path


# ---------------------------------------------------------------------------
# Tables — each function yields (filename, header, rows, note) tuples.
# ---------------------------------------------------------------------------

SUMMARY_METRICS = ("position_rmse", "position_mae",
                   "velocity_rmse", "velocity_mae")


def metrics_tables(results_dir: Path):
    src = results_dir / "evaluation_results.json"
    if not src.exists():
        print(f"  ! No evaluation results found at {src}")
        return
    results = json.loads(src.read_text())

    avg = results.get("average_metrics", {})
    summary_rows = [(name, sci(avg[name]), sci(avg.get(f"{name}_std", 0.0)))
                    for name in SUMMARY_METRICS if name in avg]
    yield ("metrics_summary.csv", ("Metric", "Value", "Std Dev"),
           summary_rows, "Metrics summary")

    per_sim = results.get("per_simulation_metrics", [])
    if per_sim:
        columns = [c for c in per_sim[0]
                   if not c.startswith("trajectory_distances")]
        rows = [[sim_id] + [sci(record.get(c, "")) for c in columns]
                for sim_id, record in enumerate(per_sim, start=1)]
        yield ("metrics_per_simulation.csv", ["simulation_id"] + columns,
               rows, "Per-simulation metrics")


TRAJ_HEADER = ("timestep", "time", "particle_id", "mass",
               "pos_x", "pos_y", "pos_z", "vel_x", "vel_y", "vel_z")


def trajectory_tables(data_dir: Path, sim_id: int = 0,
                      max_steps: int = 50, max_particles: int = 5):
    ckpt_dir = data_dir / "checkpoints"
    manager = CheckpointManager(str(ckpt_dir)) if ckpt_dir.exists() else None
    names = manager.trajectory_names() if manager is not None else []
    if not names:
        print(f"  ! No trajectory files found under {data_dir}/checkpoints")
        return
    name = names[min(sim_id, len(names) - 1)]
    source = manager.trajectory_path(name)
    if source.suffix == ".h5":
        try:
            import h5py  # noqa: F401
        except ImportError:
            print("  ! h5py not installed, skipping trajectory export")
            return

    traj = manager.load_trajectory(name)
    n_steps, n_particles = traj["positions"].shape[:2]
    steps = min(max_steps, n_steps)
    parts = min(max_particles, n_particles)
    pos = traj["positions"][:steps, :parts]
    vel = traj["velocities"][:steps, :parts]
    mass = traj["masses"][:parts]
    times = traj["times"][:steps]
    t_first, t_last = traj["times"][0], traj["times"][-1]

    def traj_rows():
        for t in range(steps):
            for p in range(parts):
                yield (t, f"{times[t]:.6f}", p, f"{mass[p]:.6e}",
                       *(f"{pos[t, p, axis]:.6e}" for axis in range(3)),
                       *(f"{vel[t, p, axis]:.6e}" for axis in range(3)))

    yield ("sample_trajectory.csv", TRAJ_HEADER, traj_rows(),
           f"Sample trajectory ({steps} steps, {parts} particles)")

    info_rows = (("Total Particles", n_particles),
                 ("Total Timesteps", n_steps),
                 ("Time Range", f"{t_first:.4f} to {t_last:.4f}"),
                 ("Source File", source.name))
    yield ("simulation_info.csv", ("Parameter", "Value"), info_rows,
           "Simulation info")


def history_tables(model_dir: Path):
    src = model_dir / "training_history.json"
    if not src.exists():
        print(f"  ! No training history found at {src}")
        return
    history = json.loads(src.read_text())

    def series(key):
        return history.get(key) or []

    train, val, lrs = series("train_loss"), series("val_loss"), \
        series("learning_rate")
    rows = [(epoch + 1,
             f"{train[epoch]:.6e}",
             f"{val[epoch]:.6e}" if epoch < len(val) else "",
             f"{lrs[epoch]:.6e}" if epoch < len(lrs) else "")
            for epoch in range(len(train))]
    yield ("training_history.csv",
           ("epoch", "train_loss", "val_loss", "learning_rate"),
           rows, "Training history")


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------

def build_parser():
    parser = argparse.ArgumentParser(description="Export data to CSV")
    parser.add_argument("--data-dir", "-d", type=str, default="./data")
    parser.add_argument("--model-dir", "-m", type=str, default="./models")
    parser.add_argument("--results-dir", "-r", type=str, default="./results")
    parser.add_argument("--output-dir", "-o", type=str,
                        default="./results/csv")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    rule = "=" * 50
    print(f"{rule}\nEXPORTING DATA TO CSV\n{rule}")
    print(f"Output directory: {out_dir}\n")

    sections = (
        ("Exporting evaluation metrics...",
         metrics_tables(Path(args.results_dir))),
        ("Exporting sample trajectory...",
         trajectory_tables(Path(args.data_dir))),
        ("Exporting training history...",
         history_tables(Path(args.model_dir))),
    )
    for heading, tables in sections:
        print(heading)
        for filename, header, rows, note in tables:
            path = write_table(out_dir, filename, header, rows)
            print(f"  + {note}: {path}")
        print()

    print(f"{rule}\nCSV EXPORT COMPLETE\n{rule}")
    print(f"\nAll CSV files saved to: {out_dir}/")
    print("\nFiles created:")
    for produced in sorted(out_dir.glob("*.csv")):
        print(f"  - {produced.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
