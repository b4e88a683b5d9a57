"""Reductions of the program's own spans and counters that the per-layer
metrics share (each metric's reader is a file of its own under
``perfbench/metrics/``).

The spans are ``nbody_gnn_hpc_torch.utils.profiling``'s: the program
records them on every thread while a ``torch.profiler`` session is open,
so the traced span turns them on, and their times are on the clock of the
trace's device operations.  Every function takes the run's
:class:`perfbench.run.Reading` and returns None where there is nothing to
read: a program that records no spans or keeps no such counter, no trace,
an incomplete trace, or no span of that name in it.
"""

import bisect
from typing import List, Optional, Tuple

from perfbench import readers

Intervals = List[Tuple[int, int]]


def merged(intervals) -> Intervals:
    """The union of (start_ns, end_ns) intervals as sorted disjoint ones."""
    out: Intervals = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def length_ns(intervals: Intervals) -> int:
    return sum(e - s for s, e in intervals)


def overlap_ns(a: Intervals, b: Intervals) -> int:
    """Nanoseconds covered by both of two merged interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def traced_spans(trace) -> Optional[list]:
    """The program's spans recorded in the traced span, or None where the
    program records none.  Spans of an earlier session in the process
    (the CPU tests run several) ended before this one opened, which was at
    most ``window_s`` before its first device operation."""
    try:
        from nbody_gnn_hpc_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    first = min(s for _, s, _ in trace.device_ops)
    since = first - int(trace.window_s * 1e9)
    return [s for s in recorded_spans() if s.end_ns >= since]


def _trace_and_spans(reading):
    trace = readers.complete_trace(reading)
    if trace is None or trace.window_s <= 0:
        return None, None
    spans = traced_spans(trace)
    return (trace, spans) if spans is not None else (None, None)


def busy_intervals(trace) -> Intervals:
    return merged((s, e) for _, s, e in trace.device_ops)


def named(spans, name: str) -> Intervals:
    return merged((s.start_ns, s.end_ns) for s in spans if s.name == name)


def idle_inside(reading, name: str) -> Optional[float]:
    """Device-idle time inside the union of the ``name`` spans (any
    thread), over the traced span, in %."""
    trace, spans = _trace_and_spans(reading)
    if trace is None:
        return None
    inside = named(spans, name)
    if not inside:
        return None
    idle = length_ns(inside) - overlap_ns(inside, busy_intervals(trace))
    return 100.0 * idle / 1e9 / trace.window_s


def idle_outside(reading, name: str) -> Optional[float]:
    """``idle_share`` less :func:`idle_inside`: idle time outside the
    ``name`` spans, over the traced span, in %."""
    inside = idle_inside(reading, name)
    share = readers.idle_share(reading)
    if inside is None or share is None:
        return None
    return share - inside


def busy_inside(reading, name: str) -> Optional[float]:
    """The share of the trace's device busy time that lies inside the
    ``name`` spans, in %: how well the spans' clock and the trace's
    agree where every operation is launched inside one."""
    trace, spans = _trace_and_spans(reading)
    if trace is None:
        return None
    busy = busy_intervals(trace)
    inside = named(spans, name)
    if not busy or not inside:
        return None
    return 100.0 * overlap_ns(busy, inside) / length_ns(busy)


def device_ms_per_span(reading, name: str, per: str,
                       most_busy: float = 0.5) -> Optional[float]:
    """Device milliseconds of the operations that start inside ``name``
    spans, a ``per`` span.  None where the device is busy over
    ``most_busy`` of the traced span: a deep launch queue starts an
    operation long after the host span that launched it."""
    trace, spans = _trace_and_spans(reading)
    if trace is None or trace.busy_s() > most_busy * trace.window_s:
        return None
    count = sum(1 for s in spans if s.name == per)
    inside = named(spans, name)
    if count == 0 or not inside:
        return None
    starts = [s for s, _ in inside]
    total = 0
    for _, s, e in trace.device_ops:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < inside[i][1]:
            total += e - s
    return total / 1e6 / count


def queue_wait_ms(reading) -> Optional[float]:
    """Mean ``nbody_batch_queue_seconds`` a request, in ms: micro-batched
    requests' wait from enqueue to the start of their dispatch's rollout,
    over the run's requests."""
    batcher = reading.state.get("batcher")
    count = getattr(batcher, "queue_count", 0)
    if not count:
        return None
    return 1e3 * batcher.queue_seconds / count


def json_ms(reading) -> Optional[float]:
    """Mean ``nbody_json_seconds`` decode + encode a compute request, in
    ms, over the run's requests."""
    httpd = reading.state.get("httpd")
    stages = getattr(getattr(httpd, "metrics", None), "json", None)
    if not stages or not stages["decode"][1]:
        return None
    return 1e3 * (stages["decode"][0] + stages["encode"][0]) \
        / stages["decode"][1]
