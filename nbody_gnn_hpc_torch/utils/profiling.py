"""Tracing and profiling hooks: named wall-clock stage timers (the datagen
report uses them), a device trace and named regions inside it.  Port of
``nbody_gnn_hpc_tpu/utils/profiling.py``, with ``torch.profiler`` where the
JAX package used ``jax.profiler``."""

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates wall-clock seconds by stage name.  Work enqueued on the
    GPU inside a stage counts only as far as the stage waits for it."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'stage':<30} {'seconds':>10}  {'share':>6}"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            share = (t / total * 100) if total else 0.0
            lines.append(f"{name:<30} {t:>10.3f}  {share:>5.1f}%")
        lines.append(f"{'total':<30} {total:>10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the CUDA device, and write it to ``log_dir`` as a Chrome trace
    (``trace-<time>-<pid>.json``; Perfetto and chrome://tracing open it).
    A no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"))


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
