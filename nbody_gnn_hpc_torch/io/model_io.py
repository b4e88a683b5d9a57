"""Checkpoints in the JAX package's format, read and written by the port.

The JAX package writes a pickle of numpy arrays (``format``
``nbody_gnn_hpc_tpu.pickle.v1``) whose ``model_state_dict`` is a nested
dict of Flax parameters, e.g. ``layer_0/edge_proj_target/kernel`` (256,
256).  :func:`params_from_jax` renames them to this package's module names
and transposes every Dense kernel: Flax stores (in, out), ``nn.Linear``
stores (out, in).

Only ``model_state_dict``, ``norm_stats`` and the ``quantization`` marker
are read by ``load_into``; a weight-only quantized serving checkpoint
(:mod:`nbody_gnn_hpc_torch.predict.quantize`) is dequantized to float32.
The production ``models/best_rollout_model.pt`` unpickles with numpy
alone.  A training checkpoint of the JAX package (``models/best_model.pt``)
holds optax's optimizer-state classes: where optax is not importable,
:func:`load_checkpoint` reads them as plain tuples of their fields (the
port never reads a JAX optimizer state).  :func:`save_checkpoint` writes
the same keys with :func:`params_to_jax` parameters, and the port's
optimizer state as numpy arrays, so its files load in the JAX package and
unpickle with numpy alone.
"""

import os
import pickle
import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


class _OptaxState(tuple):
    """An optax optimizer-state record (a NamedTuple) read where optax is
    not importable: its fields, in order, as a tuple."""

    __slots__ = ()

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


class _Unpickler(pickle.Unpickler):
    """Reads optax's state classes as :class:`_OptaxState` subclasses of
    the same name when optax itself cannot be imported."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except ImportError:
            if module.split(".")[0] != "optax":
                raise
            return type(name, (_OptaxState,), {"__slots__": (),
                                               "__module__": module})


def load_checkpoint(filepath) -> Dict:
    """Unpickle a checkpoint file.

    Unpickling runs code named in the file: load only checkpoints this
    project wrote.
    """
    with open(filepath, "rb") as f:
        return _Unpickler(f).load()


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _flatten(val, path)
        else:
            yield path, val


def params_from_jax(state_dict: dict) -> Dict[str, torch.Tensor]:
    """Flax parameter tree -> ``NBodyGNN`` state dict (float32 tensors).

    ``layer_i`` -> ``layers.i``, ``norm_i`` -> ``norms.i``; ``kernel`` ->
    ``weight`` transposed, LayerNorm ``scale`` -> ``weight``.  Leaves are
    numpy arrays, or tensors, which stay on their device.
    """
    out = {}
    for path, val in _flatten(state_dict):
        arr = val.detach().float() if torch.is_tensor(val) else \
            np.asarray(val, np.float32)
        parts = path.split("/")
        head = re.fullmatch(r"(layer|norm)_(\d+)", parts[0])
        if head:
            parts[:1] = [f"{head.group(1)}s", head.group(2)]
        leaf = parts[-1]
        if leaf == "kernel":
            parts[-1], arr = "weight", arr.T
        elif leaf == "scale":
            parts[-1] = "weight"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {path!r}")
        out[".".join(parts)] = arr.contiguous() if torch.is_tensor(arr) \
            else torch.tensor(arr)  # a writable copy
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor],
                  numpy: bool = True) -> dict:
    """``NBodyGNN`` state dict -> Flax parameter tree (the inverse of
    :func:`params_from_jax`): ``layers.i`` -> ``layer_i``, a 2-D ``weight``
    -> ``kernel`` transposed, a 1-D (LayerNorm) ``weight`` -> ``scale``.
    Leaves are numpy arrays, or with ``numpy=False`` float32 tensors on the
    state dict's device."""
    tree: dict = {}
    for name, val in state_dict.items():
        arr = val.detach().cpu().numpy().astype(np.float32) if numpy \
            else val.detach().float()
        parts = name.split(".")
        if parts[0] in ("layers", "norms"):
            parts[:2] = [f"{parts[0][:-1]}_{parts[1]}"]
        if parts[-1] == "weight":
            if arr.ndim == 2:
                parts[-1] = "kernel"
                arr = np.ascontiguousarray(arr.T) if numpy \
                    else arr.t().contiguous()
            else:
                parts[-1] = "scale"
        elif parts[-1] != "bias":
            raise ValueError(f"unexpected parameter {name!r}")
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = arr
    return tree


def _to_numpy(tree: Any) -> Any:
    """Nested dicts/lists of tensors -> the same of numpy arrays."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def save_checkpoint(filepath, *, params, opt_state=None, scheduler_state=None,
                    best_val_loss=None, history=None, norm_stats=None,
                    model_config=None, extra: Optional[Dict] = None) -> str:
    """Write a checkpoint with the JAX package's keys (reference
    ``train.py:540-547``): ``params`` is a Flax tree (:func:`params_to_jax`),
    ``opt_state`` the optimizer's ``state_dict()``; tensors are stored as
    numpy arrays; ``extra`` adds keys (the ``quantization`` marker).
    Written to a temporary file and renamed, so a crash never leaves a torn
    checkpoint at ``filepath``."""
    filepath = Path(filepath)
    filepath.parent.mkdir(parents=True, exist_ok=True)
    ckpt = {
        "model_state_dict": _to_numpy(params),
        "optimizer_state_dict": _to_numpy(opt_state),
        "scheduler_state_dict": _to_numpy(scheduler_state),
        "best_val_loss": best_val_loss,
        "history": history,
        "norm_stats": _to_numpy(norm_stats),
        "model_config": model_config,
        "format": "nbody_gnn_hpc_tpu.pickle.v1",
    }
    if extra:
        ckpt.update(extra)
    tmppath = filepath.with_name(filepath.name + ".tmp")
    with open(tmppath, "wb") as f:
        pickle.dump(ckpt, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmppath, filepath)
    return str(filepath)


# The training loop's own files; resume ignores inference promotions such
# as best_rollout_model.pt.
_TRAIN_CKPT_RE = re.compile(
    r"^(final_model|best_model|checkpoint_epoch_\d+)\.pt$")


def _tie_rank(name: str) -> int:
    """At one epoch: final_model is written last, a cadence checkpoint
    next, best_model first."""
    if name.startswith("final_model"):
        return 2
    return 1 if name.startswith("checkpoint_epoch_") else 0


def latest_checkpoint(model_dir) -> Optional[str]:
    """Filename of the training checkpoint with the highest recorded epoch
    (``scheduler_state_dict.epoch``) in ``model_dir``, or None.  Powers
    ``train_model --resume auto``; unreadable files are skipped, so a file
    torn by a crash does not block recovery."""
    candidates = {}
    for path in sorted(Path(model_dir).glob("*.pt")):
        if not _TRAIN_CKPT_RE.match(path.name):
            continue
        try:
            ckpt = load_checkpoint(path)
        except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
                ImportError, ValueError):
            continue
        if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
            sched = ckpt.get("scheduler_state_dict") or {}
            candidates[path.name] = int(sched.get("epoch", 0) or 0)
    if not candidates:
        return None
    return max(candidates, key=lambda n: (candidates[n], _tie_rank(n)))


def load_into(model: nn.Module, ckpt: dict) -> Optional[dict]:
    """Copy a JAX checkpoint's parameters into ``model`` (strict: every
    name and shape must match). Returns its ``norm_stats`` (or None).  The
    weights of a quantized serving checkpoint are dequantized to float32;
    :class:`~nbody_gnn_hpc_torch.predict.Predictor` keeps them quantized."""
    state = ckpt.get("model_state_dict", ckpt)
    if ckpt.get("quantization"):
        from nbody_gnn_hpc_torch.predict.quantize import (MODES,
                                                          dequantize_params)

        if ckpt["quantization"] not in MODES:
            raise ValueError(f"checkpoint is marked "
                             f"{ckpt['quantization']!r}-quantized; the port "
                             f"reads {MODES}")
        state = dequantize_params(state)
    params = params_from_jax(state)
    model.load_state_dict(params, strict=True)
    stats = ckpt.get("norm_stats")
    if stats is None:
        return None
    return {k: np.asarray(v, np.float32) for k, v in stats.items()}
