"""Checkpoint I/O: model checkpoints, simulation states, trajectories and
windowed training sets."""

from nbody_gnn_hpc_torch.io.checkpoint import (TRAJECTORY_FORMATS,
                                               CheckpointManager,
                                               create_training_dataset,
                                               h5_compression_kwargs)
from nbody_gnn_hpc_torch.io.model_io import (latest_checkpoint,
                                             load_checkpoint, load_into,
                                             params_from_jax, params_to_jax,
                                             save_checkpoint)

__all__ = ["TRAJECTORY_FORMATS", "CheckpointManager",
           "create_training_dataset", "h5_compression_kwargs",
           "latest_checkpoint", "load_checkpoint", "load_into",
           "params_from_jax", "params_to_jax", "save_checkpoint"]
