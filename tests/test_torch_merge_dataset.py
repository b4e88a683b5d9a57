"""The port's ``merge_dataset`` command
(nbody_gnn_hpc_torch/merge_dataset.py) against the JAX package's
``scripts/merge_dataset.py``, on the CPU.

Five tiny trajectory files (N=8, 30 frames, from a NumPy seed) are written
once as HDF5 and once as npz.  The JAX script merges the HDF5 copy, the
port both: every dataset must equal the JAX script's array for array
(float32, so exactly), attribute for attribute, in its masses and in its
chunking and compression, and the two stores must give the same files.
The printed messages must be the JAX script's, the directory aside.
"""

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import pytest

from nbody_gnn_hpc_torch import merge_dataset
from nbody_gnn_hpc_torch.io import CheckpointManager
from nbody_gnn_hpc_torch.ops import LAUNCH_LINE

REPO = Path(__file__).resolve().parent.parent
N, FRAMES, N_FILES = 8, 30, 5
SPLITS = ("train_dataset.h5", "val_dataset.h5")


def _load_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_merge_dataset_script", REPO / "scripts" / "merge_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jmerge = _load_jax_script()


def _trajectory(rng, frames: int, n: int):
    """A trajectory record as the store saves it: float64 fields, the
    masses float32 as the simulator keeps them."""
    return SimpleNamespace(
        positions=rng.randn(frames, n, 3), velocities=rng.randn(frames, n, 3),
        accelerations=rng.randn(frames, n, 3),
        times=np.arange(frames) * 1e-3, steps=np.arange(frames),
        masses=rng.uniform(1e10, 1e12, n).astype(np.float32))


# (frames, particles) of the files that differ from N_FILES x (30, 8); and
# the split.
CASES = {
    "base": ({}, 0.2),
    # The second file has another N: both commands skip it.
    "mismatched_n": ({1: (FRAMES, N + 1)}, 0.2),
    # The one validation file is shorter than a window: no val file.
    "split_without_samples": ({4: (10, N)}, 0.2),
    # All files train: no val file.
    "no_validation": ({}, 0.0),
}


def _write_stores(root: Path, differing: dict) -> None:
    rng = np.random.RandomState(0)
    trajs = [_trajectory(rng, *differing.get(i, (FRAMES, N)))
             for i in range(N_FILES)]
    for sub, fmt in (("jax", "h5"), ("port_h5", "h5"), ("port_npz", "npz")):
        manager = CheckpointManager(str(root / sub / "checkpoints"))
        for i, traj in enumerate(trajs):
            manager.save_trajectory(traj, f"sim_{i:04d}",
                                    trajectory_format=fmt)


def _read(path: Path) -> dict:
    with h5py.File(path, "r") as f:
        out = {key: f[key][:] for key in f}
        out["attrs"] = {key: f.attrs[key] for key in f.attrs}
        out["layout"] = {key: (f[key].dtype, f[key].chunks, f[key].compression,
                               f[key].compression_opts) for key in f}
    return out


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_equals_the_jax_script(case, tmp_path, monkeypatch, capsys):
    differing, test_size = CASES[case]
    _write_stores(tmp_path, differing)
    flags = ["--sequence-length", "10", "--test-size", str(test_size)]

    monkeypatch.setattr(sys, "argv", ["merge_dataset.py", "-o",
                                      str(tmp_path / "jax"), *flags])
    jmerge.main()
    want_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "D")
    outs = {}
    for sub in ("port_h5", "port_npz"):
        assert merge_dataset.main(["-o", str(tmp_path / sub), *flags]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[-1].startswith(LAUNCH_LINE)
        outs[sub] = "\n".join(lines[:-1]) + "\n"
    assert outs["port_h5"].replace(str(tmp_path / "port_h5"), "D") == want_out
    # The npz store names its files by their own suffix.
    assert (outs["port_npz"].replace(str(tmp_path / "port_npz"), "D")
            .replace("_trajectory.npz", "_trajectory.h5")) == want_out

    written = [s for s in SPLITS if (tmp_path / "jax" / s).exists()]
    assert written == (["train_dataset.h5"] if case in (
        "split_without_samples", "no_validation") else list(SPLITS))
    for split in SPLITS:
        for sub in ("port_h5", "port_npz"):
            assert (tmp_path / sub / split).exists() == (split in written)
    for split in written:
        want = _read(tmp_path / "jax" / split)
        assert "masses" in want and want["inputs"].shape[1:] == (10, N, 6)
        _same(_read(tmp_path / "port_h5" / split), want)
        _same(_read(tmp_path / "port_npz" / split), want)
    if case == "mismatched_n":
        assert "Skipping D/checkpoints/sim_0001_trajectory.h5" in want_out
        assert _read(tmp_path / "jax" / "train_dataset.h5")["attrs"][
            "n_samples"] == 3 * (FRAMES - 10)


def test_merge_without_a_store(tmp_path, capsys):
    """No checkpoints directory: the JAX script's error and exit code."""
    assert merge_dataset.main(["-o", str(tmp_path)]) == 1
    assert "Error: Checkpoint directory not found" in capsys.readouterr().out
