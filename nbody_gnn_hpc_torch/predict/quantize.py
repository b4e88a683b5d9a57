"""Weight-only quantization for serving: bf16 / int8 checkpoints.

Port of ``nbody_gnn_hpc_tpu/predict/quantize.py``.  Both modes touch only
the kernels (float leaves with two or more dimensions); biases and
LayerNorm parameters stay float32.  Compute stays float32: the quantized
tree is what lies on disk and on the device, and the weights are
dequantized once per rollout call (:class:`~nbody_gnn_hpc_torch.predict.
Predictor`).

- ``bf16``: kernels cast to bfloat16.
- ``int8``: kernels stored as int8 with a symmetric scale per output
  channel, ``{"q": int8, "scale": float32}`` with ``q = round(w / s)``,
  ``s = max|w| / 127`` over the input rows: the error of a weight is at most
  ``s / 2``.

The functions work on the checkpoint's parameter tree in the JAX package's
layout (nested dicts, a kernel is (in, out), so the output channel is the
last axis).  Leaves are numpy arrays (a file) or torch tensors (the device);
a result has the kind of leaf it was given.  Files keep the checkpoint's
keys plus a ``"quantization"`` marker and drop the optimizer state, and
load in the JAX package and here alike.  A bf16 file holds
``ml_dtypes.bfloat16`` arrays, so writing or reading one needs the
``ml_dtypes`` package; int8 files and in-memory bf16 need numpy and torch
only.
"""

from pathlib import Path
from typing import Any, Callable, Dict

import numpy as np
import torch

MODES = ("bf16", "int8")


def _ml_dtypes():
    try:
        import ml_dtypes
    except ImportError as e:
        raise ImportError(
            "a bf16 checkpoint file holds ml_dtypes.bfloat16 arrays: install "
            "ml_dtypes to write or read one (int8 files and "
            "Predictor.quantize('bf16') in memory do not need it)") from e
    return ml_dtypes


def _is_kernel(leaf: Any) -> bool:
    """Float leaves with ndim >= 2 are quantized; 1-D leaves stay."""
    if torch.is_tensor(leaf):
        return leaf.dim() >= 2 and leaf.is_floating_point()
    return (hasattr(leaf, "ndim") and leaf.ndim >= 2
            and np.issubdtype(np.asarray(leaf).dtype, np.floating))


def _is_quant_leaf(x: Any) -> bool:
    """An int8 kernel is exactly ``{"q", "scale"}``; no module of this
    model has parameters of those names."""
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts (an int8 kernel is a leaf)."""
    if isinstance(tree, dict) and not _is_quant_leaf(tree):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _quant_int8_leaf(w) -> Dict[str, Any]:
    if torch.is_tensor(w):
        w = w.float()
        # A tensor divisor: CUDA divides by a Python scalar as a product
        # with its reciprocal, one ulp off numpy's quotient in some scales.
        scale = w.abs().amax(dim=tuple(range(w.dim() - 1))) / torch.full(
            (), 127.0, device=w.device)
        scale = scale.clamp_min(1e-12)
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}
    w = np.asarray(w, np.float32)
    scale = np.max(np.abs(w), axis=tuple(range(w.ndim - 1))) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale}


def _bf16_leaf(w):
    if torch.is_tensor(w):
        return w.to(torch.bfloat16)
    return np.asarray(w).astype(_ml_dtypes().bfloat16)


def quantize_params(params: Any, mode: str) -> Any:
    """Quantize a parameter tree: int8 kernels become ``{"q", "scale"}``,
    bf16 kernels are cast; every other leaf passes through."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    leaf = _quant_int8_leaf if mode == "int8" else _bf16_leaf
    return _map(lambda x: leaf(x) if _is_kernel(x) else x, params)


def dequantize_params(params: Any) -> Any:
    """Inverse of :func:`quantize_params`: every float leaf back to
    float32 (on an unquantized tree it is a cast)."""

    def deq(x):
        if _is_quant_leaf(x):
            q, scale = x["q"], x["scale"]
            if torch.is_tensor(q):
                return q.float() * scale.float()
            return np.asarray(q).astype(np.float32) * np.asarray(
                scale, np.float32)
        if torch.is_tensor(x):
            return x.float() if x.is_floating_point() else x
        if hasattr(x, "ndim") and np.issubdtype(np.asarray(x).dtype,
                                                np.floating):
            return np.asarray(x).astype(np.float32)
        if getattr(getattr(x, "dtype", None), "name", "") == "bfloat16":
            return np.asarray(x).astype(np.float32)  # no numpy float kind
        return x

    return _map(deq, params)


def tree_to_device(params: Any, device) -> Any:
    """A (quantized) tree of numpy arrays as tensors on ``device``, each in
    its stored type (a bfloat16 array has no numpy type torch reads, so its
    bits go across as int16)."""

    def put(x):
        if _is_quant_leaf(x):
            return {k: put(v) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            bits = torch.from_numpy(arr.view(np.int16).copy())
            return bits.view(torch.bfloat16).to(device)
        return torch.from_numpy(arr.copy()).to(device)

    return _map(put, params)


def quantize_checkpoint(src: str, dst: str, mode: str) -> Dict[str, Any]:
    """Rewrite a training checkpoint as a quantized serving checkpoint: the
    same keys, a ``"quantization"`` marker, no optimizer or scheduler
    state.  Returns ``{"src_bytes", "dst_bytes", "ratio", "mode"}``."""
    from nbody_gnn_hpc_torch.io.model_io import (load_checkpoint,
                                                 save_checkpoint)

    ckpt = load_checkpoint(src)
    if ckpt.get("quantization") is not None:
        raise ValueError(
            f"{src} is already a {ckpt['quantization']!r}-quantized serving "
            "checkpoint; quantize the original training checkpoint instead")
    save_checkpoint(
        dst, params=quantize_params(ckpt.get("model_state_dict", ckpt), mode),
        best_val_loss=ckpt.get("best_val_loss"), history=ckpt.get("history"),
        norm_stats=ckpt.get("norm_stats"),
        model_config=ckpt.get("model_config"), extra={"quantization": mode})
    src_b, dst_b = Path(src).stat().st_size, Path(dst).stat().st_size
    return {"src_bytes": src_b, "dst_bytes": dst_b,
            "ratio": round(src_b / max(dst_b, 1), 2), "mode": mode}
