"""The N-body GNN."""

from nbody_gnn_hpc_torch.models.gnn import (FULL_LAYER_BF16_MISSING,
                                            NBodyGNN,
                                            ParticleInteractionLayer,
                                            count_parameters,
                                            model_from_config)

__all__ = ["FULL_LAYER_BF16_MISSING", "NBodyGNN",
           "ParticleInteractionLayer", "count_parameters",
           "model_from_config"]
