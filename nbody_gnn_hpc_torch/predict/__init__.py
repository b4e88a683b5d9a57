"""Rollout inference and weight-only quantization for serving."""

from nbody_gnn_hpc_torch.predict.predictor import Predictor, compare_with_hpc
from nbody_gnn_hpc_torch.predict.quantize import (MODES, dequantize_params,
                                                  quantize_checkpoint,
                                                  quantize_params)

__all__ = ["MODES", "Predictor", "compare_with_hpc", "dequantize_params",
           "quantize_checkpoint", "quantize_params"]
