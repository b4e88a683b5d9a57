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

With a ``mesh`` (:mod:`nbody_gnn_hpc_torch.parallel`) every rank holds the
data and the model, walks the same permutation and takes its rows of each
batch through the data-parallel step in ``gspmd`` numerics, so the run
equals the single-device run to float32 rounding; the validation sums are
reduced over the mesh, and only the mesh's first rank prints and writes
files.

``ckpt_backend="orbax"`` writes the parameters and the AdamW state as
async checkpoints (:class:`~nbody_gnn_hpc_torch.io.orbax_io.OrbaxCheckpointer`,
DCP's format) under ``model_dir/orbax/<step>/`` and the small metadata in
a synchronous sidecar, ``model_dir/orbax_index.json``, keyed by the pickle
backend's filenames, so ``save_model`` / ``load_model`` keep one surface.
"""

import json
import os
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

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
from nbody_gnn_hpc_torch.train.steps import (file_state, load_file_state,
                                             make_optimizer, make_train_step)
from nbody_gnn_hpc_torch.utils.watchdog import maybe_watchdog

# The loss details every step reports, in the order validation sums them.
LOSS_KEYS = ("total", "position", "velocity", "energy", "momentum")


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
                 seed: int = 0,
                 mesh=None,
                 ckpt_backend: str = "pickle"):
        """``mesh``: a data-parallel mesh (``parallel.make_mesh`` or
        ``make_hybrid_mesh``) that every rank builds its Trainer with, the
        batch size a multiple of its size; None trains on ``device``
        alone.

        ``ckpt_backend``: ``"pickle"`` (the JAX package's ``.pt`` files,
        written synchronously) or ``"orbax"`` (async writes; with a mesh
        only its first rank writes, and every rank reads)."""
        del num_workers
        if ckpt_backend not in ("pickle", "orbax"):
            raise ValueError(f"unknown ckpt_backend {ckpt_backend!r}")
        self.ckpt_backend = ckpt_backend
        self._orbax = None  # the checkpointer, made at the first use
        self._orbax_step = 0
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
        step_args = (self.model, self.optimizer, self.edge_index,
                     self.norm_stats["state_mean"],
                     self.norm_stats["state_std"], mass_feat)
        step_kwargs = dict(
            noise_std=noise_std, masses=self.masses,
            criterion=self.criterion, use_physics_loss=use_physics_loss,
            schedule=make_step_schedule(learning_rate, self.steps_per_epoch))
        self.mesh = mesh
        if mesh is None:
            self._step = make_train_step(*step_args, **step_kwargs)
            self._lead = True
        else:
            from nbody_gnn_hpc_torch.parallel.train_dp import \
                make_dp_train_step

            self._step = make_dp_train_step(*step_args, mesh=mesh,
                                            **step_kwargs)
            ranks = self._step.shard.count
            if self._batch % ranks:
                raise ValueError(f"batch size {self._batch} does not split "
                                 f"over the mesh's {ranks} ranks")
            self._lead = self._step.shard.index == 0

        # epoch_time_s is additive to the reference's history keys.
        self.history = {"train_loss": [], "val_loss": [], "learning_rate": [],
                        "energy_loss": [], "momentum_loss": [],
                        "epoch_time_s": []}
        self.best_val_loss = float("inf")
        self.current_epoch = 0
        self.step_losses = []  # every train step's loss, in order
        self._watchdog = None  # armed by train(watchdog_s=...)

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
        mine = bounds
        if self.mesh is not None:  # whole batches dealt round the ranks
            shard = self._step.shard
            mine = bounds[shard.index::shard.count]
        sums = torch.zeros(len(LOSS_KEYS), device=self.device)
        for lo, hi in mine:
            _, details = self._step.compute_loss(
                self.val_states[lo:hi], self.val_targets[lo:hi],
                deterministic=True)
            sums = sums + torch.stack([details[k] for k in LOSS_KEYS])
        if self.mesh is not None:
            sums = self._step.reduce_sum(sums)
        details = {k: v / len(bounds) for k, v in zip(LOSS_KEYS,
                                                      sums.tolist())}
        return details["total"], details

    def current_lr(self) -> float:
        return cosine_warm_restarts(max(self.current_epoch - 1, 0),
                                    self.learning_rate)

    def train(self, n_epochs: int = 50, early_stopping_patience: int = 30,
              save_every: int = 10, verbose: bool = True,
              watchdog_s: Optional[float] = None) -> Dict:
        """Full training loop with early stopping (``train.py:469-535``).

        ``watchdog_s``: arm a stall watchdog
        (:mod:`nbody_gnn_hpc_torch.utils.watchdog`) that exits the process
        with ``STALL_EXIT_CODE`` when no host readback of the losses
        completes for that many seconds, so a stalled device becomes a
        resumable failure (``train_model --resume auto``).  It must cover
        the slowest epoch and the first one's kernel builds; ``None`` or 0
        disables it.
        """
        say = print if self._lead else (lambda *a, **k: None)
        say(f"Training on {self.device}")
        say(f"Model parameters: {count_parameters(self.model):,}")
        if self.use_physics_loss:
            say(f"Physics loss: ENABLED (masses loaded for "
                f"{self.masses.shape[0]} particles)")
        else:
            say("Physics loss: DISABLED (no masses)")
        say(f"Input noise std: {self.noise_std}")

        # None/0 -> disabled; negative -> ValueError (as every command).
        # Every rank arms its own: a rank that stalls holds the others in
        # their next collective, so their watchdogs end them too.
        self._watchdog = maybe_watchdog(watchdog_s,
                                        what="training-epoch progress")
        patience_counter = 0
        stopped_early = False
        # A resumed run continues the global epoch numbering.
        start_epoch = self.current_epoch
        try:
            for epoch in range(n_epochs):
                self.current_epoch = start_epoch + epoch + 1
                # The LR in effect this epoch (the reference steps its
                # scheduler at epoch end, so epoch e runs at lr(e),
                # 0-indexed).
                current_lr = cosine_warm_restarts(start_epoch + epoch,
                                                  self.learning_rate)
                epoch_t0 = time.time()
                train_loss = self.train_epoch()
                self._beat()  # the step losses were read back
                self.history["train_loss"].append(train_loss)
                val_loss, val_details = self.validate()
                self._beat()
                self.history["val_loss"].append(val_loss)
                self.history["learning_rate"].append(current_lr)
                self.history["energy_loss"].append(
                    val_details.get("energy", 0))
                self.history["momentum_loss"].append(
                    val_details.get("momentum", 0))
                # The losses above are host floats: the device work is done.
                self.history["epoch_time_s"].append(
                    round(time.time() - epoch_t0, 3))

                if verbose and self._lead:
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

                # Every rank holds the same reduced losses, so every rank
                # stops at the same epoch.
                if patience_counter >= early_stopping_patience:
                    say(f"\nEarly stopping at epoch {self.current_epoch}")
                    stopped_early = True
                    break

                if (epoch + 1) % save_every == 0:
                    self.save_model(
                        f"checkpoint_epoch_{self.current_epoch}.pt")
            # Saving reads the parameters back from the device, and the
            # async writes must be durable before the run ends: the
            # watchdog stays armed until the last file is written.
            self.save_model("final_model.pt")
            self._save_history(completed=True, early_stopped=stopped_early)
            self._wait_durable()
        finally:
            # Disarm even on an exception: an armed watchdog left behind
            # would end a healthy process later.
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
        return self.history

    def _beat(self) -> None:
        if self._watchdog is not None:
            self._watchdog.beat()

    # -- checkpoints (train.py:537-567) -------------------------------------

    @property
    def _model_config(self) -> Dict:
        own = getattr(self.model, "model_config", None)
        if own is not None:  # a model that states its own (GNS)
            return own
        return {
            "node_input_dim": self.model.node_input_dim,
            "hidden_dim": self.model.hidden_dim,
            "n_layers": self.model.n_layers,
            "output_dim": self.model.output_dim,
            "dropout": self.model.dropout,
            "edge_impl": self.model.edge_impl,
        }

    def _wait_durable(self) -> None:
        """Block until the async writes are durable.  With a mesh the
        other ranks, which read what the first one wrote, wait for it too
        (an all-reduce read back on the host)."""
        if self._orbax is not None:
            self._orbax.wait()
        if self.ckpt_backend == "orbax" and self.mesh is not None:
            self._step.reduce_sum(torch.zeros(1, device=self.device)).item()

    def _orbax_mgr(self):
        if self._orbax is None:
            from nbody_gnn_hpc_torch.io.orbax_io import OrbaxCheckpointer

            self._orbax = OrbaxCheckpointer(str(self.model_dir / "orbax"))
            self._orbax_step = self._orbax.latest_step() or 0
        return self._orbax

    def _orbax_index_path(self) -> Path:
        return self.model_dir / "orbax_index.json"

    def _params(self) -> list:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def _flat_state(self) -> Dict:
        """What an async save writes: the parameters and each AdamW moment
        as one flat tensor (the optimizer's parameter order), every
        parameter's AdamW step, and the param groups in their file form.
        DCP's Python costs ~1 ms a tensor in the writer thread, which takes
        the GIL from the training loop: five entries instead of ~320.
        Zeros and step 0
        (what AdamW's first step starts from) before any step."""
        params = self._params()
        state = [self.optimizer.state.get(p) or {
            "step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)} for p in params]

        def flat(tensors):
            return torch.cat([t.detach().reshape(-1) for t in tensors])

        return {"params": flat(params),
                "exp_avg": flat(s["exp_avg"] for s in state),
                "exp_avg_sq": flat(s["exp_avg_sq"] for s in state),
                "step": torch.stack([s["step"] for s in state]),
                "param_groups": file_state(self.optimizer)["param_groups"]}

    def _save_orbax(self, filename: str) -> str:
        """Queue an async save of the parameters and the AdamW state at the
        next step, then write the step and the metadata under ``filename``
        into the sidecar index (a temporary file renamed: the index gates
        ``--resume auto``, so a crash must not tear it)."""
        mgr = self._orbax_mgr()
        self._orbax_step += 1
        mgr.save(self._orbax_step, self._flat_state(), force=True)
        path = self._orbax_index_path()
        index = json.loads(path.read_text()) if path.exists() else {}
        index[filename] = {
            "step": self._orbax_step,
            "scheduler_state_dict": {"epoch": self.current_epoch},
            "best_val_loss": self.best_val_loss,
            "history": self.history,
            "norm_stats": {k: np.asarray(v).tolist()
                           for k, v in self.norm_stats.items()}
            if self.norm_stats else None,
            "model_config": self._model_config,
        }
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(index, indent=2))
        os.replace(tmp, path)
        return str(self.model_dir / "orbax" / str(self._orbax_step))

    @torch.no_grad()
    def _load_orbax(self, filename: str) -> Dict:
        """Restore ``filename``'s step into the model and the optimizer;
        returns its index entry.  The optimizer's per-parameter state is
        rebuilt from the flat tensors (a fresh optimizer has none, and DCP
        fills only the structure it is given)."""
        index = json.loads(self._orbax_index_path().read_text())
        if filename not in index:
            raise FileNotFoundError(
                f"{filename} not in {self._orbax_index_path()}")
        entry = index[filename]
        mgr = self._orbax_mgr()
        mgr.wait()  # the step must be durable before it is read
        like = {k: torch.empty_like(v) if torch.is_tensor(v) else v
                for k, v in self._flat_state().items()}
        flat = mgr.restore(entry["step"], like=like)
        params = self._params()
        sizes = [p.numel() for p in params]
        moments = [flat[k].split(sizes) for k in ("exp_avg", "exp_avg_sq")]
        for p, value in zip(params, flat["params"].split(sizes)):
            p.copy_(value.view_as(p))
        load_file_state(self.optimizer, {
            "state": {i: {"step": flat["step"][i].clone(),
                          "exp_avg": moments[0][i].view_as(p).clone(),
                          "exp_avg_sq": moments[1][i].view_as(p).clone()}
                      for i, p in enumerate(params)},
            "param_groups": flat["param_groups"]})
        if entry.get("norm_stats") is not None:
            entry["norm_stats"] = {k: np.asarray(v, np.float32)
                                   for k, v in entry["norm_stats"].items()}
        return entry

    def save_model(self, filename: str) -> str:
        """A checkpoint in the JAX package's format (it loads there too),
        or with ``ckpt_backend="orbax"`` a queued async one; with a mesh
        only its first rank writes it."""
        if not self._lead:
            return str(self.model_dir / filename)
        if self.ckpt_backend == "orbax":
            return self._save_orbax(filename)
        return save_checkpoint(
            self.model_dir / filename,
            params=params_to_jax(self.model.state_dict()),
            opt_state=file_state(self.optimizer),
            scheduler_state=dict(epoch=self.current_epoch),
            best_val_loss=self.best_val_loss,
            history=self.history,
            norm_stats=self.norm_stats,
            model_config=self._model_config,
        )

    def load_model(self, filename: str) -> None:
        """Restore parameters, optimizer state (when the file holds the
        port's), best loss, history, stats and epoch."""
        if self.ckpt_backend == "orbax":
            ckpt = self._load_orbax(filename)
        else:
            ckpt = load_checkpoint(self.model_dir / filename)
            self.model.load_state_dict(
                params_from_jax(ckpt["model_state_dict"]))
            opt = ckpt.get("optimizer_state_dict")
            if isinstance(opt, dict) and {"state", "param_groups"} <= set(opt):
                load_file_state(self.optimizer, _to_torch(opt))
            elif opt is not None:
                print("  (optimizer state not in the port's format; "
                      "starting the optimizer afresh)")
        steps = [s["step"] for s in self.optimizer.state.values()
                 if "step" in s]
        self._step.count = int(steps[0]) if steps else 0
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
        if not self._lead:
            return
        payload = dict(self.history)
        if completed:
            payload["completed"] = True
            payload["early_stopped"] = bool(early_stopped)
        with open(self.model_dir / "training_history.json", "w") as f:
            json.dump(payload, f, indent=2)
