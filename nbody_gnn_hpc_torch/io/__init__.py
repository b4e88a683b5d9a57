"""Checkpoint I/O."""

from nbody_gnn_hpc_torch.io.model_io import (load_checkpoint, load_into,
                                             params_from_jax)

__all__ = ["load_checkpoint", "load_into", "params_from_jax"]
