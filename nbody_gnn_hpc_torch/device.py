"""Device selection and the physical constants shared by the port.

The port runs on the GPU. The CPU is used only when a caller asks for it
with ``device="cpu"`` (the tests do); a missing GPU is an error, never a
quiet switch to the CPU.
"""

import functools
from typing import Optional, Union

import torch

# Physical constants (reference ``src/hpc/nbody.py:18-19``).
G = 6.67430e-11
SOFTENING = 1e-9


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for explicitly.

    Raises ``RuntimeError`` when a CUDA device is wanted (the default) and
    none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available (torch.cuda.is_available() is False); "
            "pass device='cpu' to run on the CPU explicitly")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: what the
    kernels' schedules size their grids by."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def use_full_f32() -> None:
    """Keep float32 matmuls and convolutions at full float32 precision.

    The JAX reference on the CPU computes in full f32; TF32 keeps about
    three decimal digits, which would move serving outputs by more than the
    port's stated tolerances.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
