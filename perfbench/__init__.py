"""The benchmark of the PyTorch/CUDA port, ``nbody_gnn_hpc_torch``."""
