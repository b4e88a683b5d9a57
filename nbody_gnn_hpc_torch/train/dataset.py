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

import os
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
