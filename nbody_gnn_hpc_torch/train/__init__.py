"""Training: dataset, physics loss, LR schedule, train step, trainer and
the rollout fine-tune."""

from nbody_gnn_hpc_torch.train.dataset import (MANIFEST_NAME, GNNDataset,
                                               datasets_from_manifest,
                                               write_manifest)
from nbody_gnn_hpc_torch.train.loss import PhysicsInformedLoss, mse_loss
from nbody_gnn_hpc_torch.train.rollout_tune import (finetune_rollout,
                                                    load_trajectory_tensor,
                                                    make_unroll_loss,
                                                    make_unroll_step)
from nbody_gnn_hpc_torch.train.schedule import (cosine_warm_restarts,
                                                make_step_schedule)
from nbody_gnn_hpc_torch.train.steps import (clip_by_global_norm_,
                                             make_optimizer, make_train_step)
from nbody_gnn_hpc_torch.train.trainer import Trainer

__all__ = ["MANIFEST_NAME", "GNNDataset", "PhysicsInformedLoss", "Trainer",
           "clip_by_global_norm_", "cosine_warm_restarts",
           "datasets_from_manifest", "finetune_rollout",
           "load_trajectory_tensor", "make_optimizer", "make_step_schedule",
           "make_train_step", "make_unroll_loss", "make_unroll_step",
           "mse_loss", "write_manifest"]
