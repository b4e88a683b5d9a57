"""Rollout inference, weight-only quantization for serving and
rollout-aware checkpoint selection."""

from nbody_gnn_hpc_torch.predict.predictor import Predictor, compare_with_hpc
from nbody_gnn_hpc_torch.predict.quantize import (MODES, dequantize_params,
                                                  quantize_checkpoint,
                                                  quantize_params)
from nbody_gnn_hpc_torch.predict.selection import (discover_checkpoints,
                                                   score_checkpoints,
                                                   select_checkpoint)

__all__ = ["MODES", "Predictor", "compare_with_hpc", "dequantize_params",
           "discover_checkpoints", "quantize_checkpoint", "quantize_params",
           "score_checkpoints", "select_checkpoint"]
