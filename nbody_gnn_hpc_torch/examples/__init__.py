"""Demo commands over the port (ports of the repository's ``examples/``),
each run as ``python -m nbody_gnn_hpc_torch.examples.<name>``."""
