"""The port's CSV export (nbody_gnn_hpc_torch/export_csv.py) against the
JAX package's ``scripts/export_csv.py``, run unchanged as a process (it
imports no JAX), on the same files.  The CSVs must be byte-equal; from an
npz store the one difference is the source file's name in
``simulation_info.csv``."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nbody_gnn_hpc_torch import export_csv
from nbody_gnn_hpc_torch.io import CheckpointManager
from nbody_gnn_hpc_torch.sim import Trajectory

REPO = Path(__file__).resolve().parent.parent
TABLES = ("metrics_summary.csv", "metrics_per_simulation.csv",
          "sample_trajectory.csv", "simulation_info.csv",
          "training_history.csv")


def jax_export(data_dir, model_dir, results_dir, out_dir):
    """``scripts/export_csv.py`` as the JAX pipeline runs it."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "export_csv.py"),
         "-d", str(data_dir), "-m", str(model_dir), "-r", str(results_dir),
         "-o", str(out_dir)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _trajectory(n_steps=60, n=7, seed=0):
    rng = np.random.RandomState(seed)
    return Trajectory(positions=rng.randn(n_steps, n, 3) * 3,
                      velocities=rng.randn(n_steps, n, 3),
                      accelerations=rng.randn(n_steps, n, 3),
                      times=np.arange(n_steps) * 0.001,
                      steps=np.arange(n_steps),
                      masses=rng.uniform(1e10, 1e12, n).astype(np.float32))


def _workspace(root, fmt):
    """Results, history and a two-file trajectory store of form ``fmt``."""
    manager = CheckpointManager(str(root / "data" / "checkpoints"))
    for i in range(2):
        manager.save_trajectory(_trajectory(seed=i), f"sim_{i:04d}",
                                compression="lzf", trajectory_format=fmt)
    (root / "models").mkdir()
    (root / "models" / "training_history.json").write_text(json.dumps({
        "train_loss": [0.5, 0.25, 0.125], "val_loss": [0.4, 0.2],
        "learning_rate": [5e-4, 4e-4, 3e-4]}))
    (root / "results").mkdir()
    per_sim = [{"position_rmse": 1.5 + i, "velocity_rmse": 20.25,
                "energy_error": float("nan"), "n_steps": 394,
                "trajectory_distances_mean": 3.0} for i in range(2)]
    (root / "results" / "evaluation_results.json").write_text(json.dumps({
        "average_metrics": {"position_rmse": 2.0, "position_rmse_std": 0.5,
                            "velocity_rmse": 20.25, "position_mae": 1.0},
        "per_simulation_metrics": per_sim}))
    return [str(root / d) for d in ("data", "models", "results")]


def _port_export(dirs, out_dir):
    d, m, r = dirs
    assert export_csv.main(["-d", d, "-m", m, "-r", r, "-o",
                            str(out_dir)]) == 0


@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_csvs_byte_equal_to_the_jax_script(tmp_path, fmt):
    """The JAX script reads HDF5 only: from an npz store the port's
    tables are held against the JAX script on an HDF5 copy of it."""
    dirs = _workspace(tmp_path / "port", fmt)
    _port_export(dirs, tmp_path / "port_csv")
    jax_dirs = dirs if fmt == "h5" else _workspace(tmp_path / "jax", "h5")
    jax_export(*jax_dirs, tmp_path / "jax_csv")
    for name in TABLES:
        got = (tmp_path / "port_csv" / name).read_bytes()
        want = (tmp_path / "jax_csv" / name).read_bytes()
        if name == "simulation_info.csv" and fmt == "npz":
            want = want.replace(b"sim_0000_trajectory.h5",
                                b"sim_0000_trajectory.npz")
        assert got == want, name
    rows = (tmp_path / "port_csv" / "sample_trajectory.csv").read_text()
    assert len(rows.splitlines()) == 1 + 50 * 5  # 50 steps x 5 particles


def test_hdf5_store_without_h5py_skips_the_trajectory_tables(
        tmp_path, monkeypatch, capsys):
    """As the JAX script does: a printed skip of those two tables, the
    others written."""
    dirs = _workspace(tmp_path, "h5")
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py fails
    _port_export(dirs, tmp_path / "csv")
    assert "h5py not installed, skipping trajectory export" in \
        capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "csv").iterdir()) == [
        "metrics_per_simulation.csv", "metrics_summary.csv",
        "training_history.csv"]


def test_missing_inputs_are_reported_not_fatal(tmp_path, capsys):
    _port_export([str(tmp_path / d) for d in ("d", "m", "r")],
                 tmp_path / "csv")
    out = capsys.readouterr().out
    assert "No evaluation results" in out
    assert "No trajectory files" in out
    assert "No training history" in out
    assert not (tmp_path / "d").exists()  # nothing made where it reads
