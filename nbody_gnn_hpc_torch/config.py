"""Training/experiment configuration (port of ``nbody_gnn_hpc_tpu/config.py``).

The same hyperparameter names and defaults as the JAX package (and the
reference's ``src/ai/config.py``), so persisted ``models/config.json``
files round-trip between the frameworks.  ``dt = 0.01`` is the reference's
documented config drift: the datagen and evaluation pipelines use 0.001.
"""

from dataclasses import asdict, dataclass, fields

import torch


@dataclass
class TrainingConfig:
    """Hyperparameters for the N-body GNN pipeline (reference defaults)."""

    # Training
    batch_size: int = 24
    learning_rate: float = 5e-4
    epochs: int = 200
    early_stopping: int = 30

    # Model
    hidden_dim: int = 256
    n_layers: int = 6
    k_neighbors: int = 40
    dropout: float = 0.1

    # Regularization
    weight_decay: float = 1e-4
    noise_std: float = 0.003  # Input noise injection during training

    # Data generation
    particles: int = 200
    simulations: int = 300
    steps: int = 400
    dt: float = 0.01

    # Experiment
    test_size: float = 0.2
    n_test_sims: int = 10
    workers: int = 4
    sequence_length: int = 10

    @staticmethod
    def get_device() -> str:
        """The torch device the port would use: 'cuda' when a card is
        present, else 'cpu' (which the entry points take only when asked)."""
        return "cuda" if torch.cuda.is_available() else "cpu"

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainingConfig":
        """Build a config from a dict, ignoring unknown keys (forward compat)."""
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
