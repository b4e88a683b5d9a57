"""Tracing and profiling hooks: named wall-clock stage timers (the datagen
report uses them), a device trace, and the program's spans.  Port of
``nbody_gnn_hpc_tpu/utils/profiling.py``, with ``torch.profiler`` where the
JAX package used ``jax.profiler``.

A span (:func:`annotate`) marks a layer's work on the thread that does it:
the HTTP handlers, the micro-batcher's dispatches, the rollout and training
loops.  Spans record exactly while a ``torch.profiler`` session is open
anywhere in the process, on every thread: ``torch.profiler`` itself records
host operators only on the thread that opened it.  Their times are on the
profiler's clock (Kineto's host timestamps, wall-clock nanoseconds), so
they lie over the device operations of the same session.  They are kept in
memory (:func:`recorded_spans`) and :func:`device_trace` writes them into
its Chrome trace.  No span synchronises the device.
"""

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# perf_counter_ns() + CLOCK_OFFSET_NS is wall-clock ns, the clock of
# Kineto's host timestamps (``_KinetoEvent.start_ns``).
CLOCK_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
SPAN_CAPACITY = 1 << 16


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


class Span(NamedTuple):
    """A recorded span; times in ns on the profiler's clock."""

    name: str
    thread: int            # the native thread id, as Kineto's ``tid``
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the enclosing span on the same thread
    request: Optional[int]
    attrs: dict


class SpanBuffer:
    """The newest ``capacity`` spans; ``dropped`` counts those pushed out."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._spans = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0


SPANS = SpanBuffer()
# annotate(..., request=NEW_REQUEST) gives the span a fresh request id; a
# span without one takes its parent's.
NEW_REQUEST = object()
_NOOP = contextlib.nullcontext()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = threading.local()


def clock_ns() -> int:
    """Now on the profiler's clock."""
    return time.perf_counter_ns() + CLOCK_OFFSET_NS


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.tid = threading.get_native_id()
        return _local.stack


class _OpenSpan:
    __slots__ = ("name", "request", "attrs", "id", "parent", "thread",
                 "start")

    def __init__(self, name: str, request, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.request is NEW_REQUEST:
            self.request = next(_request_ids)
        elif self.request is None and parent is not None:
            self.request = parent.request
        self.id = next(_span_ids)
        self.thread = _local.tid
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _local.stack.pop()  # with-blocks of one thread close in turn
        SPANS.add(Span(self.name, self.thread, self.start + CLOCK_OFFSET_NS,
                       end + CLOCK_OFFSET_NS, self.id, self.parent,
                       self.request, self.attrs))
        return False


def annotate(name: str, request=None, **attrs):
    """A span named ``name`` over a ``with`` block, recorded while a
    profiler session is open (a shared no-op otherwise).  ``request`` is
    the request id (``NEW_REQUEST``: a fresh one; None: the parent's);
    ``attrs`` are small values kept with the span (N, steps, batch)."""
    # The process-wide flag: the thread-local _profiler_enabled() reads
    # False on every thread but the one that opened the session.
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _OpenSpan(name, request, attrs)


def current_span():
    """The innermost open span of this thread (its ``id``, ``thread`` and
    ``request``), or None when none is open or no session is."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def record_span(name: str, start_ns: int, end_ns: int, parent=None) -> None:
    """Record a span whose start and end were stamped elsewhere (times from
    :func:`clock_ns`), while a session is open.  ``parent``, an open span
    from :func:`current_span` (of any thread), gives its thread, parent and
    request; without one it is this thread's."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    if parent is None:
        _stack()
        thread, parent_id, request = _local.tid, None, None
    else:
        thread, parent_id, request = parent.thread, parent.id, parent.request
    SPANS.add(Span(name, thread, start_ns, end_ns, next(_span_ids),
                   parent_id, request, {}))


def recorded_spans() -> List[Span]:
    """The spans recorded so far, oldest first (the newest
    ``SPAN_CAPACITY``; ``SPANS.dropped`` counts the rest)."""
    return SPANS.spans()


def chrome_events(spans: List[Span], base_ns: int = 0) -> List[dict]:
    """Chrome trace events of ``spans`` (``ts`` in us after ``base_ns``),
    each on its own thread's row, with a name for every thread."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": f"thread {tid}"}}
              for tid in sorted({s.thread for s in spans})]
    for s in spans:
        events.append({
            "ph": "X", "cat": "span", "name": s.name, "pid": pid,
            "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"span": s.id, "parent": s.parent,
                     "request": s.request, **s.attrs}})
    return events


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the CUDA device, and write it to ``log_dir`` as a Chrome trace
    (``trace-<time>-<pid>.json``; Perfetto and chrome://tracing open it),
    the spans of every thread recorded meanwhile included.  A no-op when
    ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    opened = clock_ns()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(
        log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    spans = [s for s in recorded_spans() if s.end_ns >= opened]
    trace["traceEvents"].extend(chrome_events(
        spans, trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
