"""Simulation persistence: states, trajectories and windowed training sets
(port of ``nbody_gnn_hpc_tpu/io/checkpoint.py``).

The reference's HDF5 schemas (``src/hpc/checkpoint.py``: dataset names,
dtypes, attrs, gzip compression, JSON-stuffed metadata attrs), so files
written by the reference, the JAX package or this package are
interchangeable:

- single state ``<name>.h5``/``<name>.npz``: arrays + scalar attrs +
  ``metadata`` group (``checkpoint.py:64-106``);
- trajectory ``<name>_trajectory.h5``: float64 positions/velocities/
  accelerations ``(n_steps, N, 3)``, times/steps/masses datasets, ``n_steps``
  attr (``checkpoint.py:187-236``);
- training dataset: float32 ``inputs (S, L, N, 6)`` / ``targets (S, N, 6)``
  chunked and compressed, ``masses (N,)``, attrs ``sequence_length`` /
  ``n_samples`` (``checkpoint.py:302-398``).

``h5py`` is imported by the functions that touch an HDF5 file, never at
module import: a machine without it can still simulate, train from
trajectories in memory and use the npz format.
"""

import json
import os
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np


def _host(a) -> np.ndarray:
    """NumPy view of a tensor on any device or of an array."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


class CheckpointManager:
    """Save/load simulation checkpoints (API parity: ``checkpoint.py:19-299``)."""

    def __init__(self, checkpoint_dir: str = "./data/checkpoints",
                 format: str = "hdf5"):
        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.format = format

    # -- single states -------------------------------------------------------

    def save_state(self, state: Dict, name: str,
                   metadata: Optional[Dict] = None) -> str:
        if self.format == "hdf5":
            return self._save_hdf5(state, name, metadata)
        return self._save_npz(state, name, metadata)

    def _save_hdf5(self, state: Dict, name: str, metadata: Optional[Dict]) -> str:
        import h5py

        filepath = self.checkpoint_dir / f"{name}.h5"
        with h5py.File(filepath, "w") as f:
            for key, value in state.items():
                if isinstance(value, np.ndarray):
                    f.create_dataset(key, data=value, compression="gzip")
                elif isinstance(value, (int, float)):
                    f.attrs[key] = value
            if metadata:
                meta = f.create_group("metadata")
                for key, value in metadata.items():
                    meta.attrs[key] = value if isinstance(
                        value, (int, float, str)) else json.dumps(value)
            f.attrs["created_at"] = datetime.now().isoformat()
        return str(filepath)

    def _save_npz(self, state: Dict, name: str, metadata: Optional[Dict]) -> str:
        filepath = self.checkpoint_dir / f"{name}.npz"
        arrays = {k: v for k, v in state.items() if isinstance(v, np.ndarray)}
        for k, v in state.items():
            if isinstance(v, (int, float)):
                arrays[f"scalar_{k}"] = np.array(v)
        if metadata:
            arrays["metadata_json"] = np.array(json.dumps(metadata))
        np.savez_compressed(filepath, **arrays)
        return str(filepath)

    def load_state(self, name: str) -> Dict:
        hdf5_path = self.checkpoint_dir / f"{name}.h5"
        if hdf5_path.exists():
            return self._load_hdf5(hdf5_path)
        npz_path = self.checkpoint_dir / f"{name}.npz"
        if npz_path.exists():
            return self._load_npz(npz_path)
        raise FileNotFoundError(f"Checkpoint '{name}' not found")

    def _load_hdf5(self, filepath: Path) -> Dict:
        import h5py

        state = {}
        with h5py.File(filepath, "r") as f:
            for key in f.keys():
                if key != "metadata":
                    state[key] = f[key][:]
            for key in f.attrs.keys():
                if key != "created_at":
                    state[key] = f.attrs[key]
            if "metadata" in f:
                state["metadata"] = {}
                for key in f["metadata"].attrs.keys():
                    value = f["metadata"].attrs[key]
                    try:
                        state["metadata"][key] = json.loads(value)
                    except (json.JSONDecodeError, TypeError):
                        state["metadata"][key] = value
        return state

    def _load_npz(self, filepath: Path) -> Dict:
        data = np.load(filepath, allow_pickle=True)
        state = {}
        for key in data.files:
            if key.startswith("scalar_"):
                state[key[len("scalar_"):]] = data[key].item()
            elif key == "metadata_json":
                state["metadata"] = json.loads(str(data[key]))
            else:
                state[key] = data[key]
        return state

    # -- trajectories --------------------------------------------------------

    def save_trajectory(self, states: Union[List[Dict], "object"], name: str,
                        metadata: Optional[Dict] = None,
                        compression: str = "gzip") -> str:
        """Save a full trajectory.

        Accepts either the reference's list-of-state-dicts
        (``checkpoint.py:172-236``) or a stacked
        :class:`~nbody_gnn_hpc_torch.sim.integrator.Trajectory` (fast path —
        three bulk array writes instead of n_steps row writes).

        ``compression``: 'gzip' (reference schema default), 'lzf' (~5-10x
        faster writes, larger files), or 'none'. Readers are agnostic —
        h5py decompresses transparently whichever codec wrote the file.
        """
        import h5py

        if isinstance(states, list):
            positions = np.stack([s["positions"] for s in states])
            velocities = np.stack([s["velocities"] for s in states])
            accelerations = np.stack([s["accelerations"] for s in states])
            times = np.array([s.get("time", i) for i, s in enumerate(states)])
            steps = np.array([s.get("step", i) for i, s in enumerate(states)])
            masses = np.asarray(states[0]["masses"])
        else:  # Trajectory of tensors (any device) or host arrays
            positions, velocities, accelerations, times, steps, masses = (
                _host(getattr(states, f)) for f in (
                    "positions", "velocities", "accelerations", "times",
                    "steps", "masses"))

        filepath = self.checkpoint_dir / f"{name}_trajectory.h5"
        n_steps = positions.shape[0]
        comp_kwargs = h5_compression_kwargs(compression)
        # Write-to-temp + atomic rename: a crash mid-write (host OOM,
        # SIGKILL while the datagen writer thread is flushing) must never
        # leave a truncated file at the final path: resume
        # (`trajectory_exists`) is existence-based, so a torn file there
        # would be skipped as "done" and crash the later load.
        tmppath = filepath.with_name(filepath.name + ".tmp")
        with h5py.File(tmppath, "w") as f:
            f.attrs["n_steps"] = n_steps
            # float64 on disk — schema parity with checkpoint.py:197-208.
            for key, arr in (("positions", positions),
                             ("velocities", velocities),
                             ("accelerations", accelerations)):
                f.create_dataset(key, data=arr.astype(np.float64),
                                 **comp_kwargs)
            f.create_dataset("times", data=np.asarray(times))
            f.create_dataset("steps", data=np.asarray(steps))
            f.create_dataset("masses", data=masses)
            if metadata:
                meta = f.create_group("metadata")
                for key, value in metadata.items():
                    meta.attrs[key] = value if isinstance(
                        value, (int, float, str)) else json.dumps(value)
            f.attrs["created_at"] = datetime.now().isoformat()
        os.replace(tmppath, filepath)
        return str(filepath)

    def load_trajectory(self, name: str) -> Dict:
        import h5py

        filepath = self.checkpoint_dir / f"{name}_trajectory.h5"
        if not filepath.exists():
            raise FileNotFoundError(f"Trajectory '{name}' not found")
        with h5py.File(filepath, "r") as f:
            trajectory = {
                "positions": f["positions"][:],
                "velocities": f["velocities"][:],
                "accelerations": f["accelerations"][:],
                "times": f["times"][:],
                "steps": f["steps"][:],
                "masses": f["masses"][:],
                "n_steps": f.attrs["n_steps"],
            }
            if "metadata" in f:
                trajectory["metadata"] = {}
                for key in f["metadata"].attrs.keys():
                    value = f["metadata"].attrs[key]
                    try:
                        trajectory["metadata"][key] = json.loads(value)
                    except (json.JSONDecodeError, TypeError):
                        trajectory["metadata"][key] = value
        return trajectory

    # -- management ----------------------------------------------------------

    def list_checkpoints(self) -> List[str]:
        checkpoints = []
        for f in self.checkpoint_dir.iterdir():
            if f.suffix in (".h5", ".npz"):
                checkpoints.append(f.stem.replace("_trajectory", " (trajectory)"))
        return sorted(checkpoints)

    def trajectory_exists(self, name: str) -> bool:
        """Idempotent-resume hook used by datagen (``generate_data.py:129``)."""
        return (self.checkpoint_dir / f"{name}_trajectory.h5").exists()

    def delete_checkpoint(self, name: str) -> bool:
        for ext in (".h5", ".npz", "_trajectory.h5"):
            filepath = self.checkpoint_dir / f"{name}{ext}"
            if filepath.exists():
                filepath.unlink()
                return True
        return False


def h5_compression_kwargs(compression: str, gzip_level: int = 4) -> Dict:
    """h5py ``create_dataset`` kwargs for a compression choice.

    'gzip' is the reference schema default (checkpoint.py:352); 'lzf' writes
    ~5-10x faster on one core at ~1.4x the file size; 'none' is fastest and
    largest. All three produce files every HDF5 reader opens transparently.
    """
    if compression == "gzip":
        return {"compression": "gzip", "compression_opts": gzip_level}
    if compression == "lzf":
        return {"compression": "lzf"}
    if compression in ("none", None):
        return {}
    raise ValueError(f"unknown compression {compression!r} "
                     "(expected gzip/lzf/none)")


def create_training_dataset(trajectories: List[Dict],
                            output_path: str,
                            sequence_length: int = 10,
                            stride: int = 1,
                            masses: Optional[np.ndarray] = None,
                            gzip_level: int = 4,
                            compression: str = "gzip") -> str:
    """Sliding-window (inputs, target) dataset with the reference's exact
    HDF5 schema (``checkpoint.py:302-398``).

    Window semantics parity: for each trajectory with n saved states, samples
    are windows starting at i in ``range(0, n - L, stride)`` — input is
    states [i, i+L), target is state i+L; so S = ceil((n - L) / stride)
    per trajectory.  Vectorized with stride tricks instead of the reference's
    per-sample loop.
    """
    import h5py

    total_samples = 0
    per_traj = []
    for traj in trajectories:
        n_steps = int(traj["n_steps"])
        n_samples = max(0, -(-(n_steps - sequence_length) // stride))
        # reference loop range(0, n_steps - L, stride) yields ceil((n-L)/stride)
        if n_steps - sequence_length <= 0:
            n_samples = 0
        per_traj.append(n_samples)
        total_samples += n_samples

    if total_samples == 0:
        raise ValueError("No samples could be created from trajectories")

    n_particles = trajectories[0]["positions"].shape[1]
    in_shape = (sequence_length, n_particles, 6)
    tgt_shape = (n_particles, 6)

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)

    comp_kwargs = h5_compression_kwargs(compression, gzip_level)
    with h5py.File(output_path, "w") as f:
        # gzip level 4 is the reference schema default (checkpoint.py:352);
        # level 1 writes ~3x faster on one core; lzf/none faster still.
        inputs_ds = f.create_dataset(
            "inputs", shape=(total_samples,) + in_shape, dtype="float32",
            chunks=(min(100, total_samples),) + in_shape, **comp_kwargs)
        targets_ds = f.create_dataset(
            "targets", shape=(total_samples,) + tgt_shape, dtype="float32",
            chunks=(min(100, total_samples),) + tgt_shape, **comp_kwargs)

        idx = 0
        for traj, n_samples in zip(trajectories, per_traj):
            if n_samples == 0:
                continue
            state = np.concatenate(
                [_host(traj["positions"]), _host(traj["velocities"])],
                axis=-1).astype(np.float32)  # (n_steps, N, 6)
            starts = np.arange(0, state.shape[0] - sequence_length, stride)
            # (S, L, N, 6) windows via fancy indexing (bulk, then one write).
            windows = state[starts[:, None] + np.arange(sequence_length)[None, :]]
            targets = state[starts + sequence_length]
            inputs_ds[idx:idx + n_samples] = windows
            targets_ds[idx:idx + n_samples] = targets
            idx += n_samples

        f.attrs["sequence_length"] = sequence_length
        f.attrs["n_samples"] = total_samples
        f.attrs["created_at"] = datetime.now().isoformat()
        if masses is not None:
            f.create_dataset("masses", data=np.asarray(masses, np.float32))

    print(f"Created dataset with {total_samples} samples at {output_path}")
    return str(output_path)
