"""Rate probes of the card's float32 FMA pipe and special-function unit:
CUDA kernels + plain versions.

Port of the two Pallas kernels of ``benchmarks/roofline.py``:

- :func:`fma_probe` (kernel 10, ``_vpu_fma_kernel``): per element of a
  float32 tensor, accumulators a_n starting at x + start[n] run ``steps``
  steps of a_n <- a_n * mul[n] + add, where add is x itself (the kernel's
  form, the default) or a constant.
- :func:`rsqrt_probe` (kernel 11, ``_vpu_rsqrt_kernel``): a_n starting at
  x + start[n] run ``steps`` steps of a_n <- rsqrt(a_n) + add.

Both return (a_1 + a_2) + (a_3 + a_4) with four accumulators, or a_1 with
one.  The defaults are the Pallas kernels'; the same functions give the
script's dependent chains and its four-accumulator XLA chain with other
arguments (``nbody_gnn_hpc_torch/roofline.py`` calls them so).

CUDA tensors go to the kernels in ``csrc/probes.cu`` (its source note
states what bounds them on the H100); each wrapper's ``launches`` counts
them.  CPU tensors go to the ``*_reference`` functions, the same loops in
torch ops: a multiply and an add rounded to float32 once, as the kernel's
fused multiply-add is, and ``torch.rsqrt`` then an add.  Nothing falls back: on a CUDA tensor a
wrapper launches its kernel or raises.
"""

import ctypes
from typing import Optional, Sequence

import torch

KERNEL_STEPS = 1024                                # benchmarks/roofline.py:177
KERNEL_FMA_MUL = (0.9999, 0.9998, 0.9997, 0.9996)  # :186-187
KERNEL_FMA_START = (0.0, 0.0, 0.0, 0.0)            # :197, (x, x, x, x)
KERNEL_RSQRT_START = (0.0, 1.0, 2.0, 3.0)          # :226, (x, x+1, x+2, x+3)
RSQRT_ADD = 1e-4                                   # :216


def _check_accumulators(start: Sequence[float],
                        mul: Optional[Sequence[float]] = None) -> None:
    if len(start) not in (1, 4) or (mul is not None and len(mul) != len(start)):
        raise ValueError(f"the probes run 1 or 4 accumulators, one start "
                         f"(and one multiplier) each; got {len(start)} "
                         f"starts" + ("" if mul is None else
                                      f", {len(mul)} multipliers"))


def _accumulators(x: torch.Tensor, start: Sequence[float]):
    return [x + torch.tensor(c, dtype=torch.float32, device=x.device)
            for c in start]


def _combine(acc) -> torch.Tensor:
    return acc[0] if len(acc) == 1 else (acc[0] + acc[1]) + (acc[2] + acc[3])


def fma_probe_reference(x: torch.Tensor, steps: int = KERNEL_STEPS,
                        mul: Sequence[float] = KERNEL_FMA_MUL,
                        start: Sequence[float] = KERNEL_FMA_START,
                        add: Optional[float] = None) -> torch.Tensor:
    """Plain version of kernel 10: the same loop, each step a multiply and
    an add of the float32 operands taken in float64 and rounded to float32
    once, as the kernel's fused multiply-add rounds once (the product of two
    float32 numbers is exact in float64).  A float32 multiply and add would
    round twice, and with multipliers as close to 1 as 0.9999 the loop
    barely contracts, so over 1,024 steps the two drift apart by more than
    a float32 tolerance (``tests/test_torch_probes.py`` measures it)."""
    _check_accumulators(start, mul)
    acc = _accumulators(x, start)
    c = [torch.tensor(v, dtype=torch.float32, device=x.device).double()
         for v in mul]
    b = (x if add is None else torch.tensor(add, dtype=torch.float32,
                                            device=x.device)).double()
    for _ in range(steps):
        acc = [(a.double() * cq + b).float() for a, cq in zip(acc, c)]
    return _combine(acc)


def rsqrt_probe_reference(x: torch.Tensor, steps: int = KERNEL_STEPS,
                          start: Sequence[float] = KERNEL_RSQRT_START,
                          add: float = RSQRT_ADD) -> torch.Tensor:
    """Plain version of kernel 11: the same loop, ``torch.rsqrt`` then an
    add."""
    _check_accumulators(start)
    acc = _accumulators(x, start)
    b = torch.tensor(add, dtype=torch.float32, device=x.device)
    for _ in range(steps):
        acc = [torch.rsqrt(a) + b for a in acc]
    return _combine(acc)


def _check(name: str, x: torch.Tensor, steps: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes a float32 tensor, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor (a copy would "
                         f"add memory traffic to a rate probe)")
    if steps < 0:
        raise ValueError(f"{name} takes steps >= 0, got {steps}")


def _launch(symbol: str, wrapper, x: torch.Tensor, steps: int,
            start: Sequence[float], *params) -> torch.Tensor:
    """Launch ``symbol`` (x, out, n, steps, n_acc, *params, stream) on x's
    stream and count it.  A params entry that is a sequence goes as a host
    float array, a number as a float."""
    from nbody_gnn_hpc_torch.ops.cuda_build import load_library

    _check(wrapper.__name__, x, steps)
    args = [(ctypes.c_float * len(v))(*v) if isinstance(v, (tuple, list))
            else ctypes.c_float(v) for v in params]
    fn = getattr(load_library("probes"), symbol)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int]
                   + [ctypes.POINTER(ctypes.c_float)
                      if isinstance(a, ctypes.Array) else ctypes.c_float
                      for a in args] + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), steps, len(start),
                *args, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


def fma_probe(x: torch.Tensor, steps: int = KERNEL_STEPS,
              mul: Sequence[float] = KERNEL_FMA_MUL,
              start: Sequence[float] = KERNEL_FMA_START,
              add: Optional[float] = None) -> torch.Tensor:
    """Float32 FMA rate probe (kernel 10; JAX counterpart
    ``_vpu_fma_kernel`` of ``benchmarks/roofline.py``).  ``len(mul)`` = 1
    or 4 accumulators start at x + ``start``; each step is
    a <- fma(a, mul, add), add = x when ``add`` is None.  x float32,
    contiguous; returns a tensor shaped as x.  CUDA tensors launch the
    kernel (``launches`` counts it), CPU tensors take
    :func:`fma_probe_reference`."""
    if x.device.type == "cpu":
        return fma_probe_reference(x, steps, mul, start, add)
    _check_accumulators(start, mul)
    return _launch("nbody_fma_probe", fma_probe, x, steps, start,
                   tuple(mul), tuple(start), 1.0 if add is None else 0.0,
                   0.0 if add is None else add)


def rsqrt_probe(x: torch.Tensor, steps: int = KERNEL_STEPS,
                start: Sequence[float] = KERNEL_RSQRT_START,
                add: float = RSQRT_ADD) -> torch.Tensor:
    """rsqrt rate probe (kernel 11; JAX counterpart ``_vpu_rsqrt_kernel``
    of ``benchmarks/roofline.py``).  ``len(start)`` = 1 or 4 accumulators
    start at x + ``start``; each step is a <- rsqrt(a) + add.  x float32,
    contiguous; returns a tensor shaped as x.  CUDA tensors launch the
    kernel (``launches`` counts it), CPU tensors take
    :func:`rsqrt_probe_reference`."""
    if x.device.type == "cpu":
        return rsqrt_probe_reference(x, steps, start, add)
    _check_accumulators(start)
    return _launch("nbody_rsqrt_probe", rsqrt_probe, x, steps, start,
                   tuple(start), add)


fma_probe.launches = 0
rsqrt_probe.launches = 0
