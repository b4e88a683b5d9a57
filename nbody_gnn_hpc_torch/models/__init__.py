"""The N-body GNN."""

from nbody_gnn_hpc_torch.models.gnn import (NBodyGNN,
                                            ParticleInteractionLayer,
                                            count_parameters,
                                            model_from_config)

__all__ = ["NBodyGNN", "ParticleInteractionLayer", "count_parameters",
           "model_from_config"]
