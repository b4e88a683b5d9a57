"""Training manager (port of ``nbody_gnn_hpc_tpu/train/trainer.py``).

Parity target: ``Trainer`` (reference ``src/ai/train.py:282-567``): the
same hyperparameters, physics loss, epoch-stepped cosine warm restarts,
global-norm clip 1.0, input noise with the pos resync, early stopping,
checkpoint cadence (best on improvement, every ``save_every`` epochs,
final), history keys and printed epoch line.

The data lives on the device for the whole run.  An epoch is a Python loop
of steps over a permutation drawn from the trainer's ``torch.Generator``
(on the device), with the remainder dropped; the step losses are read back
once per epoch (``step_losses``).  Every random draw (permutation, noise,
dropout) comes from that one generator, seeded by ``seed``, so a run is
reproducible.
"""

import json
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from nbody_gnn_hpc_torch.device import resolve_device, use_full_f32
from nbody_gnn_hpc_torch.io.model_io import (load_checkpoint,
                                             params_from_jax, params_to_jax,
                                             save_checkpoint)
from nbody_gnn_hpc_torch.models.gnn import NBodyGNN, count_parameters
from nbody_gnn_hpc_torch.train.loss import PhysicsInformedLoss
from nbody_gnn_hpc_torch.train.schedule import (cosine_warm_restarts,
                                                make_step_schedule)
from nbody_gnn_hpc_torch.train.steps import make_optimizer, make_train_step


def _to_torch(tree):
    """Numpy leaves of a stored optimizer state -> tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return tree


class Trainer:
    """Training manager for the N-body GNN (reference surface:
    ``train.py:282``).  ``device``: cuda by default, the CPU only when
    asked for."""

    def __init__(self,
                 model: NBodyGNN,
                 train_dataset,
                 val_dataset=None,
                 model_dir: str = "./models",
                 device=None,
                 learning_rate: float = 5e-4,
                 batch_size: int = 24,
                 use_physics_loss: bool = True,
                 num_workers: int = 2,  # parity argument; no host workers
                 weight_decay: float = 1e-4,
                 noise_std: float = 0.003,
                 n_epochs: int = 200,
                 seed: int = 0):
        del num_workers
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.model_dir = Path(model_dir)
        self.model_dir.mkdir(parents=True, exist_ok=True)
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.noise_std = noise_std
        self.use_physics_loss = use_physics_loss
        self.n_epochs = n_epochs

        # -- data to the device, once -------------------------------------
        self.train_states, self.train_targets = \
            train_dataset.device_arrays(self.device)
        self.n_train = int(self.train_states.shape[0])
        self.n_particles = int(self.train_states.shape[1])
        if val_dataset is not None:
            self.val_states, self.val_targets = \
                val_dataset.device_arrays(self.device)
            self.n_val = int(self.val_states.shape[0])
        else:
            self.val_states = self.val_targets = None
            self.n_val = 0
        self.edge_index = torch.as_tensor(train_dataset.edge_index,
                                          device=self.device).long()
        self.masses = torch.as_tensor(train_dataset.get_masses_tensor(),
                                      device=self.device)
        self.norm_stats = train_dataset.get_normalization_stats()
        mass_feat = (self.masses / self.masses.mean())[:, None]

        # -- model, loss, optimizer ---------------------------------------
        # Every draw of the run comes from this generator; the weights come
        # from a CPU generator of the same seed (the same on every device).
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.criterion = PhysicsInformedLoss() if use_physics_loss else None
        self._batch = min(batch_size, self.n_train)
        self.steps_per_epoch = max(1, self.n_train // self._batch)
        self.optimizer = make_optimizer(self.model, learning_rate,
                                        weight_decay)
        self._step = make_train_step(
            self.model, self.optimizer, self.edge_index,
            self.norm_stats["state_mean"], self.norm_stats["state_std"],
            mass_feat, noise_std=noise_std, masses=self.masses,
            criterion=self.criterion, use_physics_loss=use_physics_loss,
            schedule=make_step_schedule(learning_rate, self.steps_per_epoch))

        # epoch_time_s is additive to the reference's history keys.
        self.history = {"train_loss": [], "val_loss": [], "learning_rate": [],
                        "energy_loss": [], "momentum_loss": [],
                        "epoch_time_s": []}
        self.best_val_loss = float("inf")
        self.current_epoch = 0
        self.step_losses = []  # every train step's loss, in order

    # -- reference surface --------------------------------------------------

    def train_epoch(self) -> float:
        """One epoch (``train.py:396-435``); returns the mean train loss
        (dropout and noise on, as the reference reports it)."""
        nb, batch = self.steps_per_epoch, self._batch
        perm = torch.randperm(self.n_train, generator=self.generator,
                              device=self.device)
        batch_ids = perm[:nb * batch].view(nb, batch)
        losses = torch.stack([
            self._step(self.train_states[ids], self.train_targets[ids],
                       self.generator) for ids in batch_ids]).tolist()
        self.step_losses.extend(losses)
        return sum(losses) / nb

    @torch.no_grad()
    def validate(self) -> Tuple[float, Dict[str, float]]:
        """(val_loss, details) with dropout and noise off
        (``train.py:437-467``).  Every sample takes part; per-batch losses
        are weighted equally, the smaller last batch included, as the
        reference's loader without drop_last does."""
        if self.val_states is None:
            return float("nan"), {}
        batch = min(self._batch, self.n_val)
        n_batches = max(1, self.n_val // batch)
        bounds = [(i * batch, (i + 1) * batch) for i in range(n_batches)]
        if self.n_val > n_batches * batch:
            bounds.append((n_batches * batch, self.n_val))
        sums = None
        for lo, hi in bounds:
            _, details = self._step.compute_loss(
                self.val_states[lo:hi], self.val_targets[lo:hi],
                deterministic=True)
            sums = details if sums is None else {
                k: sums[k] + v for k, v in details.items()}
        details = {k: float(v) / len(bounds) for k, v in sums.items()}
        return details.get("total", float("nan")), details

    def current_lr(self) -> float:
        return cosine_warm_restarts(max(self.current_epoch - 1, 0),
                                    self.learning_rate)

    def train(self, n_epochs: int = 50, early_stopping_patience: int = 30,
              save_every: int = 10, verbose: bool = True) -> Dict:
        """Full training loop with early stopping (``train.py:469-535``)."""
        print(f"Training on {self.device}")
        print(f"Model parameters: {count_parameters(self.model):,}")
        if self.use_physics_loss:
            print(f"Physics loss: ENABLED (masses loaded for "
                  f"{self.masses.shape[0]} particles)")
        else:
            print("Physics loss: DISABLED (no masses)")
        print(f"Input noise std: {self.noise_std}")

        patience_counter = 0
        stopped_early = False
        # A resumed run continues the global epoch numbering.
        start_epoch = self.current_epoch
        for epoch in range(n_epochs):
            self.current_epoch = start_epoch + epoch + 1
            # The LR in effect this epoch (the reference steps its scheduler
            # at epoch end, so epoch e runs at lr(e), 0-indexed).
            current_lr = cosine_warm_restarts(start_epoch + epoch,
                                              self.learning_rate)
            epoch_t0 = time.time()
            train_loss = self.train_epoch()
            self.history["train_loss"].append(train_loss)
            val_loss, val_details = self.validate()
            self.history["val_loss"].append(val_loss)
            self.history["learning_rate"].append(current_lr)
            self.history["energy_loss"].append(val_details.get("energy", 0))
            self.history["momentum_loss"].append(
                val_details.get("momentum", 0))
            # The losses above are host floats: the device work is done.
            self.history["epoch_time_s"].append(
                round(time.time() - epoch_t0, 3))

            if verbose:
                best_marker = (" ★ BEST" if val_loss < self.best_val_loss
                               else "")
                print(f"  Epoch {self.current_epoch:3d} | "
                      f"train: {train_loss:.4f} | val: {val_loss:.4f} | "
                      f"E: {val_details.get('energy', 0):.4f} | "
                      f"M: {val_details.get('momentum', 0):.4f} | "
                      f"lr: {current_lr:.2e}{best_marker}")

            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.save_model("best_model.pt")
                patience_counter = 0
            else:
                patience_counter += 1

            if patience_counter >= early_stopping_patience:
                print(f"\nEarly stopping at epoch {self.current_epoch}")
                stopped_early = True
                break

            if (epoch + 1) % save_every == 0:
                self.save_model(f"checkpoint_epoch_{self.current_epoch}.pt")
        self.save_model("final_model.pt")
        self._save_history(completed=True, early_stopped=stopped_early)
        return self.history

    # -- checkpoints (train.py:537-567) -------------------------------------

    @property
    def _model_config(self) -> Dict:
        return {
            "node_input_dim": self.model.node_input_dim,
            "hidden_dim": self.model.hidden_dim,
            "n_layers": self.model.n_layers,
            "output_dim": self.model.output_dim,
            "dropout": self.model.dropout,
            "edge_impl": self.model.edge_impl,
        }

    def save_model(self, filename: str) -> str:
        """A checkpoint in the JAX package's format (it loads there too)."""
        return save_checkpoint(
            self.model_dir / filename,
            params=params_to_jax(self.model.state_dict()),
            opt_state=self.optimizer.state_dict(),
            scheduler_state=dict(epoch=self.current_epoch),
            best_val_loss=self.best_val_loss,
            history=self.history,
            norm_stats=self.norm_stats,
            model_config=self._model_config,
        )

    def load_model(self, filename: str) -> None:
        """Restore parameters, optimizer state (when the file holds the
        port's), best loss, history, stats and epoch."""
        ckpt = load_checkpoint(self.model_dir / filename)
        self.model.load_state_dict(params_from_jax(ckpt["model_state_dict"]))
        opt = ckpt.get("optimizer_state_dict")
        if isinstance(opt, dict) and {"state", "param_groups"} <= set(opt):
            self.optimizer.load_state_dict(_to_torch(opt))
            steps = [s["step"] for s in self.optimizer.state.values()
                     if "step" in s]
            self._step.count = int(steps[0]) if steps else 0
        elif opt is not None:
            print("  (optimizer state not in the port's format; starting "
                  "the optimizer afresh)")
        self.best_val_loss = ckpt.get("best_val_loss", float("inf"))
        if ckpt.get("history"):
            self.history = ckpt["history"]
            n = len(self.history.get("train_loss", []))
            times = self.history.setdefault("epoch_time_s", [])
            self.history["epoch_time_s"] = [None] * (n - len(times)) + times
        if ckpt.get("norm_stats") is not None:
            self.norm_stats = ckpt["norm_stats"]
        sched = ckpt.get("scheduler_state_dict") or {}
        self.current_epoch = int(sched.get("epoch", 0))

    def _save_history(self, completed: bool = False,
                      early_stopped: bool = False) -> None:
        """Write training_history.json; ``completed`` adds the markers that
        ``train_model --resume auto`` reads (only in the file, never in
        ``self.history``, so no mid-run checkpoint carries a stale one)."""
        payload = dict(self.history)
        if completed:
            payload["completed"] = True
            payload["early_stopped"] = bool(early_stopped)
        with open(self.model_dir / "training_history.json", "w") as f:
            json.dump(payload, f, indent=2)
