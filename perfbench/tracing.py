"""The traced window: torch.profiler over the device and the host, read
into what the per-layer metrics need.

:class:`Trace` holds, for the window between :meth:`Trace.start` and
:meth:`Trace.stop` (both at points where the device is idle):

- every device operation (kernels, copies, fills) as (name, start, end);
- the host's kernel-launch calls (``cudaLaunchKernel`` and its kin);
- the host's operator spans, to say what the host did while the device
  was idle;
- the delta of the program's own launch counters over the window, which
  :meth:`Trace.complete` holds against the kernels the trace saw.

The program's hand-written kernels are declared one a file,
``perfbench/kernels/<kernel>.json``:

    {"counters": {"<launch counter>": {"bf16": false}, ...},
     "pattern": "<the device kernel each launch runs once>",
     "time": ["<device kernels whose time is this kernel's>", ...]}

``counters`` names each form's counter in ``ops.launch_counts()`` and
whether that form's device kernel carries the bf16 type in its name;
``time`` is optional.  A new kernel is a new file.
"""

import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

KERNELS = Path(__file__).resolve().parent / "kernels"


def kernel_tables(folder: Path = KERNELS):
    """(counted, kernel_time) merged from the kernel files in ``folder``:
    {launch counter: (pattern, bf16)} and {kernel (the file's stem):
    (pattern, ...)}.  A counter declared twice is refused."""
    counted: Dict[str, Tuple[str, bool]] = {}
    kernel_time: Dict[str, Tuple[str, ...]] = {}
    for path in sorted(folder.glob("*.json")):
        spec = json.loads(path.read_text())
        for counter, form in spec["counters"].items():
            if counter in counted:
                raise ValueError(f"{path.name}: counter {counter!r} is "
                                 f"declared by another kernel file")
            counted[counter] = (spec["pattern"], bool(form["bf16"]))
        if "time" in spec:
            kernel_time[path.stem] = tuple(spec["time"])
    return counted, kernel_time


# The program's hand-written kernels: its launch counter's name -> (a
# pattern of the device kernel that each launch runs once, whether the
# kernel's name carries the bf16 type); and the device kernels whose time
# is a hand-written kernel's time (each launch of kernel 2 also runs a
# target pass and a parameter sum).
COUNTED, KERNEL_TIME = kernel_tables()
LAUNCH_CALLS = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|"
                          r"cudaLaunchCooperativeKernel|cuLaunchKernel|"
                          r"cuLaunchKernelEx|cuLaunchCooperativeKernel)")
BF16 = re.compile(r"bfloat16|__nv_bfloat16")


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::",
                                                 "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:limit]


def union_seconds(intervals: List[Tuple[int, int]]) -> float:
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


class Trace:
    """A profiled window; ``launch_counts`` is the program's counter
    function (``nbody_gnn_hpc_torch.ops.launch_counts``)."""

    def __init__(self, launch_counts):
        self._counts = launch_counts
        self._prof = None
        self.device_ops: List[Tuple[str, int, int]] = []
        self.launch_calls = 0
        self.host_ops: List[Tuple[str, int, int]] = []
        self.counted: Dict[str, int] = {}
        self.window_s = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._before = dict(self._counts())
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        after = self._counts()
        self.counted = {k: after[k] - self._before.get(k, 0) for k in after}
        self._read(self._prof)
        self._prof = None

    def _read(self, prof) -> None:
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        # Host-side ranges (operators, record_function) also appear on the
        # device's timeline as annotations spanning their kernels: they are
        # not device work, and are told apart by their host-side twin.
        host_names = {ev.name() for ev in events
                      if ev.device_type() != DeviceType.CUDA}
        for ev in events:
            name = ev.name()
            start, dur = ev.start_ns(), ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                if name not in host_names:
                    self.device_ops.append((name, start, start + dur))
            elif LAUNCH_CALLS.match(name):
                self.launch_calls += 1
            elif name.startswith("aten::") and dur > 0:
                self.host_ops.append((name, start, start + dur))

    # -- reductions -------------------------------------------------------

    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device_ops])

    def kernels_seen(self, pattern: str, bf16: bool) -> int:
        rx = re.compile(pattern)
        return sum(1 for name, _, _ in self.device_ops
                   if rx.search(name) and bool(BF16.search(name)) == bf16)

    def complete(self) -> Tuple[bool, Dict[str, Tuple[int, int]]]:
        """Whether each counted kernel appears in the trace as often as the
        program launched it over the window; and {counter: (launched,
        seen)} for each that launched or was seen."""
        table = {}
        for key, (pattern, bf16) in COUNTED.items():
            launched = self.counted.get(key, 0)
            seen = self.kernels_seen(pattern, bf16)
            if launched or seen:
                table[key] = (launched, seen)
        return all(a == b for a, b in table.values()), table

    def kernel_seconds(self, kernel: str) -> float:
        """Device seconds of a hand-written kernel (:data:`KERNEL_TIME`)."""
        rx = [re.compile(p) for p in KERNEL_TIME[kernel]]
        return sum(e - s for name, s, e in self.device_ops
                   if any(r.search(name) for r in rx)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device summed by the host operator running at the
        gap's middle (the outermost one, else "host")."""
        by_op: Dict[str, int] = {}
        for name, s, e in self.device_ops:
            key = short_name(name)
            by_op[key] = by_op.get(key, 0) + (e - s)
        gaps = []
        end: Optional[int] = None
        for _, s, e in sorted(self.device_ops, key=lambda t: t[1]):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        hosts = sorted(self.host_ops, key=lambda t: t[1])
        starts = [s for _, s, _ in hosts]
        by_gap: Dict[str, int] = {}
        import bisect
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            label = "host"
            i = bisect.bisect_right(starts, mid)
            # the outermost op that holds mid: the earliest-starting one
            for j in range(max(0, i - 64), i):
                name, s, e = hosts[j]
                if s <= mid < e:
                    label = name
                    break
            by_gap[label] = by_gap.get(label, 0) + (g1 - g0)
        rank = lambda d: [[k, v / 1e9] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}
