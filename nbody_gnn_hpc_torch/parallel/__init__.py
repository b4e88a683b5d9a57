"""Parallelism: process groups and device meshes, ensemble datagen on one
device or split over a mesh, and the data-parallel train step.  The JAX
package's ``PlanesEnsemble`` is a TPU layout and has no counterpart."""

from nbody_gnn_hpc_torch.parallel.datagen import (build_ensemble_state,
                                                  fetch_host_trajectory,
                                                  simulate_ensemble,
                                                  trajectory_slice)
from nbody_gnn_hpc_torch.parallel.mesh import (DATA_AXIS, DCN_AXIS,
                                               BatchSharding, batch_sharding,
                                               init_data_parallel,
                                               make_hybrid_mesh, make_mesh,
                                               pad_to_multiple, replicated,
                                               run_local_world,
                                               slice_structure)
from nbody_gnn_hpc_torch.parallel.train_dp import (DataParallelStep,
                                                   make_dp_train_step)

__all__ = ["BatchSharding", "DATA_AXIS", "DCN_AXIS", "DataParallelStep",
           "batch_sharding", "build_ensemble_state", "fetch_host_trajectory",
           "init_data_parallel", "make_dp_train_step", "make_hybrid_mesh",
           "make_mesh", "pad_to_multiple", "replicated", "run_local_world",
           "simulate_ensemble", "slice_structure", "trajectory_slice"]
