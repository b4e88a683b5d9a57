"""Checkpoint I/O."""

from nbody_gnn_hpc_torch.io.model_io import (latest_checkpoint,
                                             load_checkpoint, load_into,
                                             params_from_jax, params_to_jax,
                                             save_checkpoint)

__all__ = ["latest_checkpoint", "load_checkpoint", "load_into",
           "params_from_jax", "params_to_jax", "save_checkpoint"]
