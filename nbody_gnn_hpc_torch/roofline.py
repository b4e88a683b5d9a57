"""The card's measured ceilings: float32 FMA rate, rsqrt rate and bf16
tensor-core rate.

    python -m nbody_gnn_hpc_torch.roofline [--device cpu] [--out PATH]

Port of ``benchmarks/roofline.py`` (``main``), which measured the TPU's
ceilings "so the roofline fractions divide by a measured number, not a
datasheet one".  The port's bounds (``chip_smoke.py``, PERF.md) divide by
the H100's published peaks; this command says what the card sustains
against them.  Instruments, at the script's shapes:

- ``chain_fma_f32_tflops``: one dependent FMA chain per element,
  x <- x * 0.9999 + 1e-4, 64 x 64 steps on (1024, 1024) (the script's XLA
  ``fma_chain``; here kernel 10 with one accumulator);
- ``chain_rsqrt_grate_gps`` / ``chain_rsqrt_slot_cost``: x <- rsqrt(x) +
  1e-4 the same way (``rsqrt_chain``; kernel 11 with one accumulator), and
  its time per step over the FMA chain's, less one (the add);
- ``chain4_fma_f32_tflops``: four independent chains from x, x+1, x+2, x+3
  on (512, 512) (the script's XLA four-accumulator chain);
- ``kernel_fma_f32_tflops`` / ``kernel_fma_tslots``,
  ``kernel_rsqrt_grate_gps`` / ``kernel_rsqrt_slot_cost``: kernels 10 and
  11 as the script ran its Pallas kernels, (256, 1024), 1024 steps;
- ``tc_bf16_tflops``: a chain of 16 (4096 x 4096) @ (4096 x 4096) bf16
  products with float32 accumulation, by ``torch.matmul`` (the script's
  MXU chain; a plain large product may stay a library call).

Each rate is printed beside its share of the H100 SXM's published peak
(67 TFLOP/s float32, 67e12 / 16 rsqrt/s, 989 TFLOP/s bf16 dense), with the
card's name and power limit.  Device times by CUDA events behind a sleep
kernel; on ``--device cpu`` (asked for, as the tests do) the plain versions
run under the host clock, and no number of such a run is a device rate.
It prints one JSON line, and writes it to a file only with ``--out PATH``.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from nbody_gnn_hpc_torch.device import resolve_device
from nbody_gnn_hpc_torch.ops.probes import fma_probe, rsqrt_probe

# The shapes of benchmarks/roofline.py (:83-85, :141, :176-177, :244-248).
SHAPES = dict(chain_shape=(1024, 1024), chain_steps=64 * 64,
              chain4_shape=(512, 512), probe_shape=(256, 1024),
              probe_steps=1024, mm_size=4096, mm_chain=16)
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3
# bytes/s, float32 operations/s outside the tensor cores, special-function
# results/s (16 per clock per SM against 128 float32 FMA lanes of 2
# operations each) and bf16 tensor-core operations/s.  chip_smoke.py's
# bounds divide by these too.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_RSQRT_PER_S = PEAK_F32_PER_S / 16
PEAK_BF16_PER_S = 989e12
FMA_MUL, FMA_ADD = 0.9999, 1e-4         # the script's a, b (:98-99)
REPO = Path(__file__).resolve().parent.parent


def cuda_time_ms(fn: Callable, reps: int = 20, inner: int = 50,
                 warmup: int = 5) -> float:
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, by CUDA events, after a warm-up.  A sleep kernel
    ahead of each batch holds the stream while the host enqueues the
    calls, so the events time the device, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of device clock cycles
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def kernel_times_ms(fn, calls=20):
    """Device time of one call of each kernel that ``fn`` launches, by
    torch.profiler over ``calls`` calls: {kernel name: ms}.  Imports what
    it needs itself (``compare_checkouts`` runs its source in other
    checkouts)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0:
            name = re.search(r"(\w+_kernel)\b", ev.key)
            key = name[1] if name else ev.key[:40]
            out[key] = out.get(key, 0.0) + ev.device_time_total / 1e3 / calls
    return out


def host_time_ms(fn: Callable, reps: int = 5, inner: int = 1,
                 warmup: int = 1) -> float:
    """Median host-clock time of ``fn`` (CPU tensors)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    return float(np.median(times))


def card() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    name, _, limit = (line[0] if line else "").partition(", ")
    return {"name": name or torch.cuda.get_device_name(0),
            "power_limit": limit or "not measured"}


def probe_input(shape, seed: int, dev) -> torch.Tensor:
    """A probe's x: float32 uniform in [0.5, 1.5) from ``seed``."""
    x = np.random.RandomState(seed).uniform(0.5, 1.5, shape)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def probe_forms(chain_shape, chain_steps, chain4_shape, probe_shape,
                probe_steps, **_) -> tuple:
    """Every probe call the measurement makes, as (name, probe, shape, seed,
    steps, kwargs): the script's dependent chains (XLA's fma_chain /
    rsqrt_chain: one accumulator), its four-accumulator XLA chain, and its
    Pallas kernels (the probes' defaults).  ``chip_smoke.py`` holds each
    against its plain version at these shapes."""
    chain = dict(start=(0.0,), add=FMA_ADD)
    return (
        ("chain_fma", fma_probe, chain_shape, 0, chain_steps,
         dict(chain, mul=(FMA_MUL,))),
        ("chain_rsqrt", rsqrt_probe, chain_shape, 0, chain_steps, chain),
        ("chain4_fma", fma_probe, chain4_shape, 4, chain_steps,
         dict(mul=(FMA_MUL,) * 4, start=(0.0, 1.0, 2.0, 3.0), add=FMA_ADD)),
        ("kernel_fma", fma_probe, probe_shape, 3, probe_steps, {}),
        ("kernel_rsqrt", rsqrt_probe, probe_shape, 3, probe_steps, {}),
    )


def measure_ceilings(device, chain_shape, chain_steps, chain4_shape,
                     probe_shape, probe_steps, mm_size, mm_chain) -> dict:
    """Every quantity of ``benchmarks/roofline.py`` on ``device`` at the
    given shapes; inputs from the script's seeds.  Returns the JSON
    object the command prints."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    timed = cuda_time_ms if on_card else host_time_ms
    ms, n_updates = {}, {}
    for name, probe, shape, seed, steps, kw in probe_forms(
            chain_shape, chain_steps, chain4_shape, probe_shape, probe_steps):
        x = probe_input(shape, seed, dev)
        ms[name] = timed(lambda: probe(x, steps, **kw))
        n_updates[name] = x.numel() * steps * len(kw.get("start", (0,) * 4))

    # The bf16 product chain; w carries the script's * 0.1 (:255) so the
    # chain stays bounded without a pass of its own between products.
    rng = np.random.RandomState(1)
    w = torch.from_numpy((rng.randn(mm_size, mm_size) / np.sqrt(mm_size)
                          * 0.1).astype(np.float32)).to(dev, torch.bfloat16)
    xm = torch.from_numpy(np.random.RandomState(2).randn(
        mm_size, mm_size).astype(np.float32)).to(dev, torch.bfloat16)

    def mm_chain_run():
        y = xm
        for _ in range(mm_chain):
            y = torch.matmul(y, w)
        return y

    ms["tc_bf16_chain"] = timed(mm_chain_run, *((10, 2) if on_card else ()))

    def per_s(key):
        return n_updates[key] / (ms[key] * 1e-3)

    def slot_cost(rsqrt_key, fma_key):
        """An rsqrt step's time over an FMA step's, less one (the add)."""
        return per_s(fma_key) / per_s(rsqrt_key) - 1.0

    rates = {
        "chain_fma_f32_tflops": 2 * per_s("chain_fma") / 1e12,
        "chain4_fma_f32_tflops": 2 * per_s("chain4_fma") / 1e12,
        "chain_rsqrt_grate_gps": per_s("chain_rsqrt") / 1e9,
        "chain_rsqrt_slot_cost": slot_cost("chain_rsqrt", "chain_fma"),
        "kernel_fma_f32_tflops": 2 * per_s("kernel_fma") / 1e12,
        "kernel_fma_tslots": per_s("kernel_fma") / 1e12,
        "kernel_rsqrt_grate_gps": per_s("kernel_rsqrt") / 1e9,
        "kernel_rsqrt_slot_cost": slot_cost("kernel_rsqrt", "kernel_fma"),
        "tc_bf16_tflops": 2.0 * mm_size ** 3 * mm_chain
        / (ms["tc_bf16_chain"] * 1e-3) / 1e12,
    }
    peaks = {"chain_fma_f32_tflops": PEAK_F32_PER_S / 1e12,
             "chain4_fma_f32_tflops": PEAK_F32_PER_S / 1e12,
             "kernel_fma_f32_tflops": PEAK_F32_PER_S / 1e12,
             "kernel_fma_tslots": PEAK_F32_PER_S / 2 / 1e12,
             "chain_rsqrt_grate_gps": PEAK_RSQRT_PER_S / 1e9,
             "kernel_rsqrt_grate_gps": PEAK_RSQRT_PER_S / 1e9,
             "tc_bf16_tflops": PEAK_BF16_PER_S / 1e12}
    device_info = card() if on_card else {"name": "cpu",
                                          "power_limit": "not measured"}
    return {
        "device": device_info["name"], "power_limit":
        device_info["power_limit"],
        "timer": "cuda events" if on_card else "host clock",
        **rates,
        "published_peak": peaks,
        "share_of_published_peak": {k: rates[k] / v for k, v in peaks.items()},
        "ms": ms,
        "shapes": dict(chain_shape=list(chain_shape), chain_steps=chain_steps,
                       chain4_shape=list(chain4_shape),
                       probe_shape=list(probe_shape), probe_steps=probe_steps,
                       mm_size=mm_size, mm_chain=mm_chain),
    }


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu, asked for")
    parser.add_argument("--out", default=None,
                        help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    if args.out is not None:
        out = Path(args.out).resolve()
        if (REPO / "benchmarks") in out.parents:
            raise ValueError(f"--out {args.out}: the ceilings command never "
                             f"writes under benchmarks/ (the earlier "
                             f"rounds' benchmark)")
    result = measure_ceilings(resolve_device(args.device), **SHAPES)
    line = json.dumps(result)
    if args.out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
