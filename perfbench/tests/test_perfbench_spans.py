"""The readers of the program's spans and counters (perfbench/spans.py and
the metrics that use it) on a synthetic trace and span list."""

from types import SimpleNamespace

import pytest

from nbody_gnn_hpc_torch.utils import profiling
from perfbench import harness, readers, spans
from perfbench.run import Reading
from perfbench.tracing import Trace

MS = 1_000_000
T0 = 1_800_000_000 * 10**9  # a wall-clock origin, as Kineto's


def _span(name, start_ms, end_ms, sid=0, parent=None):
    return profiling.Span(name, 1, T0 + start_ms * MS, T0 + end_ms * MS,
                          sid, parent, None, {})


def _trace(ops_ms, window_ms=100.0, launched=None):
    trace = Trace(lambda: {})
    trace.device_ops = [(name, T0 + int(s * MS), T0 + int(e * MS))
                        for name, s, e in ops_ms]
    trace.window_s = window_ms / 1e3
    trace.counted = dict(launched or {})
    return trace


# Serving: two rollouts (10-40, 60-90 ms) of two steps each, the k-NN the
# first 5 ms of each step; device work inside and outside the rollouts.
SERVE_SPANS = [
    _span("serve.rollout", 10, 40, 1), _span("serve.rollout", 60, 90, 2),
    _span("predict.step", 10, 25, 3, 1), _span("predict.knn", 10, 15, 4, 3),
    _span("predict.step", 25, 40, 5, 1), _span("predict.knn", 25, 30, 6, 5),
    _span("predict.step", 60, 75, 7, 2), _span("predict.knn", 60, 65, 8, 7),
    _span("predict.step", 75, 90, 9, 2), _span("predict.knn", 75, 80, 10, 9),
    _span("serve.request", 0, 95, 11),
]
SERVE_OPS = [
    ("topk", 11, 14),      # starts inside a k-NN span: 3 ms
    ("topk", 14.5, 16.5),  # starts inside, ends outside: 2 ms
    ("gemm", 16, 24),      # inside the rollout, not the k-NN
    ("topk", 26, 27),      # 1 ms
    ("gemm", 66, 70),
    ("copy", 95, 97),      # outside every rollout
]


@pytest.fixture
def serve_reading(monkeypatch):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: SERVE_SPANS)
    return Reading(None, {}, {}, _trace(SERVE_OPS))


def test_idle_split_sums_to_idle_share(serve_reading):
    inside = spans.idle_inside(serve_reading, "serve.rollout")
    outside = spans.idle_outside(serve_reading, "serve.rollout")
    # rollouts 60 ms; busy inside them 11-14, 14.5-24, 26-27 and 66-70,
    # 17.5 ms: idle 42.5 of 100; busy 19.5 in all
    assert inside == pytest.approx(42.5)
    assert inside + outside == pytest.approx(readers.idle_share(
        serve_reading))
    assert spans.busy_inside(serve_reading, "serve.rollout") \
        == pytest.approx(100 * 17.5 / 19.5)


def test_knn_counts_only_operations_that_start_inside_its_spans(
        serve_reading):
    # 3 + 2 + 1 ms over 4 steps
    assert spans.device_ms_per_span(serve_reading, "predict.knn",
                                    "predict.step") == pytest.approx(1.5)


def test_knn_is_none_on_a_busy_device(monkeypatch):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: SERVE_SPANS)
    busy = Reading(None, {}, {}, _trace([("gemm", 0, 60)] + SERVE_OPS))
    assert spans.device_ms_per_span(busy, "predict.knn",
                                    "predict.step") is None


def test_every_reader_is_none_on_an_incomplete_trace(monkeypatch):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: SERVE_SPANS)
    incomplete = Reading(None, {}, {}, _trace(
        SERVE_OPS, launched={"fused_edge_fwd": 1}))
    assert spans.idle_inside(incomplete, "serve.rollout") is None
    assert spans.idle_outside(incomplete, "serve.rollout") is None
    assert spans.busy_inside(incomplete, "serve.rollout") is None
    assert spans.device_ms_per_span(incomplete, "predict.knn",
                                    "predict.step") is None
    for name in ("idle_in_rollout.largen", "idle_outside_rollout.largen",
                 "knn_ms.largen"):
        assert harness.metric_reader(name)(incomplete) is None, name


def test_readers_are_none_without_the_programs_spans(monkeypatch):
    """A program that records no spans (no ``recorded_spans``) reads as
    nothing, and so does one without the counters."""
    monkeypatch.delattr(profiling, "recorded_spans")
    reading = Reading(None, {"batcher": object(),
                             "httpd": SimpleNamespace()}, {},
                      _trace(SERVE_OPS))
    for name in ("idle_in_rollout.largen", "idle_outside_rollout.largen",
                 "knn_ms.largen", "queue_wait_ms.largen", "json_ms.largen"):
        assert harness.metric_reader(name)(reading) is None, name


def test_spans_of_an_earlier_session_are_left_out(monkeypatch):
    old = [_span("serve.rollout", -5000, -4000, 99)]
    monkeypatch.setattr(profiling, "recorded_spans",
                        lambda: old + SERVE_SPANS)
    reading = Reading(None, {}, {}, _trace(SERVE_OPS))
    assert spans.idle_inside(reading, "serve.rollout") == pytest.approx(42.5)


def test_train_phases_tile_the_idle_time(monkeypatch):
    phases = []
    for i, base in enumerate((0, 50)):
        for j, (name, a, b) in enumerate((("forward", 0, 20),
                                          ("loss", 20, 25),
                                          ("backward", 25, 45),
                                          ("update", 45, 50))):
            phases.append(_span(f"train.{name}", base + a, base + b,
                                10 * i + j))
    monkeypatch.setattr(profiling, "recorded_spans", lambda: phases)
    ops = [("k", 2, 4), ("k", 30, 40), ("k", 52, 60), ("k", 47, 48)]
    reading = Reading(None, {}, {}, _trace(ops))
    got = {name: spans.idle_inside(reading, f"train.{name}")
           for name in ("forward", "loss", "backward", "update")}
    assert got == pytest.approx({"forward": 30.0, "loss": 10.0,
                                 "backward": 30.0, "update": 9.0})
    assert sum(got.values()) == pytest.approx(readers.idle_share(reading))


def test_counter_readers():
    batcher = SimpleNamespace(queue_seconds=3.0, queue_count=4)
    metrics = SimpleNamespace(json={"decode": [0.02, 4],
                                    "encode": [0.06, 4]})
    reading = Reading(None, {"batcher": batcher,
                             "httpd": SimpleNamespace(metrics=metrics)},
                      {}, None)
    assert harness.metric_reader("queue_wait_ms.largen")(reading) \
        == pytest.approx(750.0)
    assert harness.metric_reader("json_ms.largen")(reading) \
        == pytest.approx(20.0)
    idle = Reading(None, {"batcher": SimpleNamespace(queue_seconds=0.0,
                                                     queue_count=0)},
                   {}, None)
    assert harness.metric_reader("queue_wait_ms.largen")(idle) is None
    assert harness.metric_reader("json_ms.largen")(idle) is None
