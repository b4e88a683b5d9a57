"""PyTorch/CUDA port of the N-body GNN surrogate for NVIDIA Hopper.

The JAX package ``nbody_gnn_hpc_tpu`` is the reference; this package mirrors
its layout (``ops/``, ``models/``, ``io/``, ``predict/``, ``sim/``,
``serve.py``, ``client.py``) and imports nothing from it.  Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``.

Hand-written kernels live in ``csrc/`` and are built with ``nvcc`` at first
use (see :mod:`nbody_gnn_hpc_torch.ops.cuda_build`).
"""

from nbody_gnn_hpc_torch.device import G, SOFTENING, resolve_device

__all__ = ["G", "SOFTENING", "resolve_device"]
