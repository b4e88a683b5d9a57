"""Load the JAX package's checkpoints into the port's model.

The JAX package writes a pickle of numpy arrays (``format``
``nbody_gnn_hpc_tpu.pickle.v1``) whose ``model_state_dict`` is a nested
dict of Flax parameters, e.g. ``layer_0/edge_proj_target/kernel`` (256,
256).  :func:`params_from_jax` renames them to this package's module names
and transposes every Dense kernel: Flax stores (in, out), ``nn.Linear``
stores (out, in).

Only ``model_state_dict`` and ``norm_stats`` are read.  The production
``models/best_rollout_model.pt`` unpickles with numpy alone; checkpoints
whose optimizer state holds optax classes cannot be read without optax.
"""

import pickle
import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


def load_checkpoint(filepath) -> Dict:
    """Unpickle a checkpoint file.

    Unpickling runs code named in the file: load only checkpoints this
    project wrote.
    """
    with open(filepath, "rb") as f:
        return pickle.load(f)


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
    ``weight`` transposed, LayerNorm ``scale`` -> ``weight``.
    """
    out = {}
    for path, val in _flatten(state_dict):
        arr = np.asarray(val, np.float32)
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
        out[".".join(parts)] = torch.tensor(arr)  # a writable copy
    return out


def load_into(model: nn.Module, ckpt: dict) -> Optional[dict]:
    """Copy a JAX checkpoint's parameters into ``model`` (strict: every
    name and shape must match). Returns its ``norm_stats`` (or None)."""
    if ckpt.get("quantization"):
        raise ValueError(
            f"checkpoint holds {ckpt['quantization']}-quantized weights; "
            "quantized serving is not ported yet, load a float32 checkpoint")
    params = params_from_jax(ckpt.get("model_state_dict", ckpt))
    model.load_state_dict(params, strict=True)
    stats = ckpt.get("norm_stats")
    if stats is None:
        return None
    return {k: np.asarray(v, np.float32) for k, v in stats.items()}
