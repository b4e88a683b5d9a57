"""GNN training dataset: windowed HDF5 or trajectories -> device tensors
(port of ``nbody_gnn_hpc_tpu/train/dataset.py``).

The same public surface as the JAX package (n_samples, n_particles,
masses, normalisation stats, the precomputed static edge set,
``__getitem__`` normalisation, ``get_normalization_stats`` /
``get_masses_tensor``): the (last-state, target) pairs of every window are
loaded once and :meth:`GNNDataset.device_arrays` puts them on the card, so
the training loop never reads from the host.

The normalisation-stat and edge-averaging draws are seeded
(``np.random.RandomState(12345)``), the same numpy draws as the JAX
package, so both frameworks pick the same samples.  The k-NN edges come
from the port's ``ops/knn.py``: the same neighbour set per row, the order
within a row may differ on exact distance ties.  ``h5py`` is imported only
by the HDF5 constructor.
"""

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nbody_gnn_hpc_torch.device import resolve_device
from nbody_gnn_hpc_torch.ops.knn import (fully_connected_edge_index,
                                         knn_edge_index)

_STAT_SEED = 12345  # fixed draw for norm stats / edge averaging


class GNNDataset:
    """Windowed HDF5 dataset (the JAX package's ``checkpoint.py`` schema).

    Only the LAST state of each input window is used, which is the
    reference's learning problem (``train.py:143``); ``sequence_length`` is
    kept for parity.
    """

    def __init__(self,
                 data_path: str,
                 sequence_length: int = 5,
                 k_neighbors: Optional[int] = None,
                 include_mass: bool = True,
                 external_norm_stats: Optional[Dict[str, np.ndarray]] = None):
        import h5py

        self.data_path = str(data_path)
        self.sequence_length = sequence_length
        self.k_neighbors = k_neighbors
        self.include_mass = include_mass

        with h5py.File(self.data_path, "r") as f:
            self.n_samples = int(f.attrs["n_samples"])
            self.n_particles = int(f["inputs"].shape[2])
            if "masses" in f:
                self.masses = f["masses"][:]
            else:
                # Merged files may omit masses; unit masses degrade the
                # physics loss, so say so.
                self.masses = np.ones(self.n_particles)
                print("WARNING: dataset has no 'masses'; physics loss will "
                      "use unit masses")
            self._load_tensors(f)

        self._init_stats_and_edges(external_norm_stats)

    @classmethod
    def from_trajectories(cls, trajectories, sequence_length: int = 5,
                          stride: int = 1,
                          k_neighbors: Optional[int] = None,
                          include_mass: bool = True,
                          external_norm_stats: Optional[Dict] = None):
        """The dataset straight from trajectory dicts, no windowed file.

        A windowed file's samples reduce to ``state[L-1:T-1], state[L:T]``
        per trajectory (window starts ``range(0, T-L, stride)``), so the
        two constructions give the same tensors.

        ``trajectories``: dicts with ``positions``/``velocities`` of shape
        (T, N, 3) (numpy arrays or tensors) and optionally shared
        ``masses`` (the first contributing trajectory's are used).
        """
        self = cls.__new__(cls)
        self.data_path = "<trajectories>"
        self.sequence_length = sequence_length
        self.k_neighbors = k_neighbors
        self.include_mass = include_mass

        host = lambda a: np.asarray(  # noqa: E731
            a.cpu() if torch.is_tensor(a) else a)
        lasts, targets, contributing = [], [], []
        for traj in trajectories:
            state = np.concatenate(
                [host(traj["positions"]), host(traj["velocities"])],
                axis=-1).astype(np.float32)  # (T, N, 6)
            if state.shape[0] - sequence_length <= 0:
                continue
            starts = np.arange(0, state.shape[0] - sequence_length, stride)
            lasts.append(state[starts + sequence_length - 1])
            targets.append(state[starts + sequence_length])
            contributing.append(traj)
        if not lasts:
            raise ValueError("No samples could be created from trajectories")

        self.last_states = np.concatenate(lasts)
        self.targets = np.concatenate(targets)
        self.n_samples = int(self.last_states.shape[0])
        self.n_particles = int(self.last_states.shape[1])
        m = contributing[0].get("masses")
        if m is not None:
            self.masses = host(m)
        else:
            self.masses = np.ones(self.n_particles)
            print("WARNING: trajectories have no 'masses'; physics loss "
                  "will use unit masses")

        self._init_stats_and_edges(external_norm_stats)
        return self

    def _init_stats_and_edges(self, external_norm_stats) -> None:
        k_neighbors = self.k_neighbors
        rng = np.random.RandomState(_STAT_SEED)

        if external_norm_stats is not None:
            self.state_mean = np.asarray(external_norm_stats["state_mean"],
                                         np.float32)
            self.state_std = np.asarray(external_norm_stats["state_std"],
                                        np.float32)
            print("  Using external normalization stats")
        else:
            # Per-feature mean/std over <= 500 random last states
            # (train.py:71-88), std clamped at 1e-6.
            n_stat = min(500, self.n_samples)
            idx = rng.choice(self.n_samples, n_stat, replace=False)
            flat = self.last_states[np.sort(idx)].reshape(-1, 6)
            self.state_mean = flat.mean(axis=0).astype(np.float32)
            self.state_std = np.maximum(
                flat.std(axis=0).astype(np.float32), 1e-6)

        print(f"  Normalization stats — mean: {self.state_mean}, "
              f"std: {self.state_std}")

        # Static edge set (train.py:91-122): fully connected for small N or
        # k=None, else k-NN of the average positions of <= 10 samples.
        if k_neighbors is None or k_neighbors >= self.n_particles - 1:
            self.edge_index = fully_connected_edge_index(self.n_particles)
            print(f"Using fully connected graph "
                  f"({self.edge_index.shape[1]} edges)")
        else:
            print(f"Precomputing {k_neighbors}-NN edges...")
            n_avg = min(10, self.n_samples)
            idx = rng.choice(self.n_samples, n_avg, replace=False)
            avg_positions = self.last_states[idx, :, :3].mean(axis=0)
            self.edge_index = knn_edge_index(
                torch.from_numpy(avg_positions), k_neighbors).numpy()
            print(f"  Created {self.edge_index.shape[1]} edges "
                  f"(precomputed, reused for all samples)")

        print(f"Dataset: {self.n_samples} samples, "
              f"{self.n_particles} particles")

    def _load_tensors(self, f) -> None:
        """Bulk-load last input states + targets, with an uncompressed
        ``.tensors.npz`` sidecar next to the file (decompressing the gzip'd
        production file takes minutes); the sidecar is invalidated by the
        source's size and mtime, and written best-effort."""
        src_stat = os.stat(self.data_path)
        cache_path = self.data_path + ".tensors.npz"
        tag = f"{src_stat.st_size}:{src_stat.st_mtime_ns}"
        if os.path.exists(cache_path):
            try:
                cached = np.load(cache_path)
                if str(cached["tag"]) == tag:
                    self.last_states = cached["last_states"]
                    self.targets = cached["targets"]
                    return
            except (OSError, ValueError, KeyError):
                pass  # unreadable or stale: rebuild

        self.last_states = np.empty(
            (self.n_samples, self.n_particles, 6), np.float32)
        self.targets = np.empty(
            (self.n_samples, self.n_particles, 6), np.float32)
        chunk = 2048
        for i in range(0, self.n_samples, chunk):
            j = min(i + chunk, self.n_samples)
            self.last_states[i:j] = f["inputs"][i:j, -1]
            self.targets[i:j] = f["targets"][i:j]
        try:
            np.savez(cache_path, tag=tag, last_states=self.last_states,
                     targets=self.targets)
        except OSError:
            pass  # read-only directory: no sidecar

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """Normalised sample (``train.py:140-168``): x = [norm_pos,
        norm_vel, mass/mean(mass)], pos = norm_pos, y = normalised target,
        as numpy arrays."""
        last = self.last_states[idx]
        norm = (last - self.state_mean) / self.state_std
        if self.include_mass:
            norm_mass = (self.masses / self.masses.mean()).reshape(-1, 1)
            x = np.concatenate([norm, norm_mass.astype(np.float32)], axis=1)
        else:
            x = norm
        y = (self.targets[idx] - self.state_mean) / self.state_std
        return {"x": x.astype(np.float32), "pos": norm[:, :3].copy(),
                "edge_index": self.edge_index, "y": y.astype(np.float32)}

    def get_normalization_stats(self) -> Dict[str, np.ndarray]:
        return {"state_mean": self.state_mean, "state_std": self.state_std}

    def get_masses_tensor(self) -> np.ndarray:
        """Masses as a float32 array (name kept from ``train.py:177-179``)."""
        return np.asarray(self.masses, np.float32)

    def device_arrays(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(last_states, targets), RAW float32 (normalisation and noise
        happen in the train step), on ``resolve_device(device)``: cuda
        unless the CPU is asked for."""
        dev = resolve_device(device)
        return (torch.as_tensor(self.last_states, device=dev),
                torch.as_tensor(self.targets, device=dev))


MANIFEST_NAME = "dataset_manifest.json"


def write_manifest(output_dir, train_sims, val_sims, sequence_length,
                   stride: int = 1, checkpoint_dir: str = "checkpoints"):
    """Record a ``--no-windows`` datagen run: which trajectory files form
    the train/val split and the window protocol to apply at load time, in
    place of the windowed HDF5 files that store each state about
    ``sequence_length`` times over."""
    path = Path(output_dir) / MANIFEST_NAME
    with open(path, "w") as f:
        json.dump({
            "format": "nbody-gnn-trajectory-manifest",
            "version": 1,
            "checkpoint_dir": checkpoint_dir,
            "sequence_length": int(sequence_length),
            "stride": int(stride),
            "train_sims": list(train_sims),
            "val_sims": list(val_sims),
        }, f, indent=2)
    return str(path)


def datasets_from_manifest(manifest_path, k_neighbors: Optional[int] = None,
                           include_mass: bool = True, cache: bool = True):
    """(train_dataset, val_dataset) from a ``--no-windows`` manifest.

    Equivalent to loading ``train_dataset.h5``/``val_dataset.h5`` built
    from the same trajectories: the val set uses the train set's
    normalisation stats (reference ``train_model.py:94-100``).

    ``cache``: keep an uncompressed ``.tensors.npz`` sidecar next to the
    manifest, so that a later launch does not decompress every trajectory
    file again.  It is invalidated by any change to the manifest spec or to
    the trajectory files' sizes/mtimes; norm stats and k-NN edges are
    recomputed from the cached tensors (seeded draws, identical either
    way).  The sidecar has the JAX package's format.
    """
    from nbody_gnn_hpc_torch.io.checkpoint import CheckpointManager

    manifest_path = Path(manifest_path)
    with open(manifest_path) as f:
        spec = json.load(f)
    if spec.get("format") != "nbody-gnn-trajectory-manifest":
        raise ValueError(f"{manifest_path} is not a trajectory manifest")

    ckpt_dir = manifest_path.parent / spec["checkpoint_dir"]
    manager = CheckpointManager(str(ckpt_dir))
    seq_len, stride = spec["sequence_length"], spec.get("stride", 1)
    val_names = spec.get("val_sims") or []

    cache_path = Path(str(manifest_path) + ".tensors.npz")
    file_stats = []
    for name in list(spec["train_sims"]) + list(val_names):
        try:
            st = (ckpt_dir / f"{name}_trajectory.h5").stat()
            file_stats.append((name, st.st_size, st.st_mtime_ns))
        except OSError:
            file_stats.append((name, -1, -1))
    tag = hashlib.sha256(json.dumps(
        {"train": list(spec["train_sims"]), "val": list(val_names),
         "seq": seq_len, "stride": stride, "files": file_stats},
        sort_keys=True).encode()).hexdigest()

    def _dataset(last, targets, masses, external=None):
        ds = GNNDataset.__new__(GNNDataset)
        ds.data_path = str(manifest_path)
        ds.sequence_length = seq_len
        ds.k_neighbors = k_neighbors
        ds.include_mass = include_mass
        ds.last_states = last
        ds.targets = targets
        ds.n_samples = int(last.shape[0])
        ds.n_particles = int(last.shape[1])
        ds.masses = masses
        ds._init_stats_and_edges(external)
        return ds

    if cache and cache_path.exists():
        try:
            cached = np.load(cache_path, allow_pickle=False)
            if str(cached["tag"]) == tag:
                print(f"  Loaded tensors from sidecar cache {cache_path.name}")
                train = _dataset(cached["train_states"],
                                 cached["train_targets"], cached["masses"])
                val = _dataset(cached["val_states"], cached["val_targets"],
                               cached["val_masses"],
                               external=train.get_normalization_stats()) \
                    if len(cached["val_states"]) else None
                return train, val
        except (OSError, ValueError, KeyError):
            pass  # unreadable or stale: rebuild

    def _load(names):
        return [manager.load_trajectory(n) for n in names]

    kw = dict(sequence_length=seq_len, stride=stride,
              k_neighbors=k_neighbors, include_mass=include_mass)
    train = GNNDataset.from_trajectories(_load(spec["train_sims"]), **kw)
    val = GNNDataset.from_trajectories(
        _load(val_names),
        external_norm_stats=train.get_normalization_stats(), **kw
    ) if val_names else None

    if cache:
        try:
            empty = np.zeros((0,) + train.last_states.shape[1:], np.float32)
            np.savez(cache_path, tag=tag,
                     train_states=train.last_states,
                     train_targets=train.targets,
                     val_states=val.last_states if val else empty,
                     val_targets=val.targets if val else empty,
                     masses=np.asarray(train.masses),
                     # val trajectories may carry their own masses
                     val_masses=np.asarray(val.masses if val
                                           else train.masses))
        except OSError as e:  # read-only directory: no sidecar
            print(f"  ! sidecar cache write failed: {e}")
    return train, val
