"""Rollout inference."""

from nbody_gnn_hpc_torch.predict.predictor import Predictor, compare_with_hpc

__all__ = ["Predictor", "compare_with_hpc"]
