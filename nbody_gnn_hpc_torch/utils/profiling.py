"""Named wall-clock stage timers (port of ``StageTimer`` from
``nbody_gnn_hpc_tpu/utils/profiling.py``; the datagen report uses it)."""

import contextlib
import time
from typing import Dict


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
