"""The port's spans and counters (nbody_gnn_hpc_torch/utils/profiling.py,
serve.py's /metrics series) on the CPU: the switch, threads, the shared
clock with torch.profiler, the Chrome export, the spans at the serving,
rollout and training layers, and the counters' counts."""

import json
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbody_gnn_hpc_torch.io.model_io import params_to_jax, save_checkpoint
from nbody_gnn_hpc_torch.models import NBodyGNN
from nbody_gnn_hpc_torch.ops.knn import knn_edge_index
from nbody_gnn_hpc_torch.serve import (MicroBatcher, build_replica_pool,
                                       build_service, serve)
from nbody_gnn_hpc_torch.train import make_optimizer, make_train_step
from nbody_gnn_hpc_torch.utils import device_trace, profiling
from nbody_gnn_hpc_torch.utils.profiling import (NEW_REQUEST, annotate,
                                                 recorded_spans)

N, K = 12, 4
KW = dict(node_input_dim=7, hidden_dim=8, n_layers=1, output_dim=6,
          dropout=0.0)


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.SPANS.clear()
    yield
    profiling.SPANS.clear()


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _tracing():
    return torch.autograd.profiler._is_profiler_enabled


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_annotate_records_nothing_without_a_session():
    assert not _tracing()
    a, b = annotate("a"), annotate("b", request=NEW_REQUEST, n=3)
    assert a is b  # the shared no-op
    with a:
        with b:
            pass
    profiling.record_span("c", 0, 1)
    assert profiling.current_span() is None
    assert recorded_spans() == []


def test_worker_thread_span_has_its_thread_parent_and_request():
    seen = {}

    def work():
        seen["tid"] = threading.get_native_id()
        seen["on"] = _tracing()
        with annotate("worker.outer", request=NEW_REQUEST, n=7) as outer:
            with annotate("worker.inner"):
                seen["current"] = profiling.current_span().name
        seen["outer"] = outer.id

    with _session():
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen["on"]
    spans = recorded_spans()
    outer, = _by_name(spans, "worker.outer")
    inner, = _by_name(spans, "worker.inner")
    assert seen["current"] == "worker.inner"
    assert outer.thread == inner.thread == seen["tid"]
    assert outer.id == seen["outer"] and outer.parent is None
    assert inner.parent == outer.id
    assert outer.request is not None and inner.request == outer.request
    assert outer.attrs == {"n": 7}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


# Kineto converts its cycle-counter readings to the wall clock once a
# session: its times and the spans' agree to a few us (3.3 us seen).
CLOCKS_AGREE_NS = 50_000


def test_span_shares_the_profilers_clock():
    """A main-thread span around a loop of aten::mm holds every one of the
    trace's aten::mm events and opens less than 1 ms before the first (the
    best of three sessions: a descheduled thread can hold it longer)."""
    leads = []
    for _ in range(3):
        profiling.SPANS.clear()
        a = torch.randn(64, 64)
        with _session() as prof:
            with annotate("mm.loop"):
                for _ in range(5):
                    a = a @ a
        span, = _by_name(recorded_spans(), "mm.loop")
        mm = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
        assert len(mm) == 5
        assert all(span.start_ns - CLOCKS_AGREE_NS <= s
                   and e <= span.end_ns + CLOCKS_AGREE_NS for s, e in mm)
        leads.append(min(s for s, _ in mm) - span.start_ns)
    assert min(leads) < 1_000_000, leads


def test_device_trace_writes_worker_thread_spans(tmp_path):
    tids = []

    def work():
        tids.append(threading.get_native_id())
        with annotate("worker.region", request=NEW_REQUEST, batch=2):
            torch.randn(8, 8).sum()

    with device_trace(str(tmp_path)):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    trace, = tmp_path.glob("trace-*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    ev, = [e for e in events if e.get("name") == "worker.region"]
    assert ev["ph"] == "X" and ev["cat"] == "span" and ev["tid"] == tids[0]
    assert ev["dur"] > 0 and ev["args"]["batch"] == 2
    assert ev["args"]["request"] is not None
    assert any(e.get("ph") == "M" and e.get("tid") == tids[0]
               for e in events)


def test_chrome_events_are_after_the_base():
    span = profiling.Span("s", 5, 3_000_000, 5_000_000, 1, None, 2, {})
    meta, ev = profiling.chrome_events([span], base_ns=1_000_000)
    assert meta["ph"] == "M" and meta["tid"] == 5
    assert (ev["ts"], ev["dur"]) == (2000.0, 2000.0)
    assert ev["args"] == {"span": 1, "parent": None, "request": 2}


def test_span_buffer_keeps_the_newest_and_counts_the_rest():
    buf = profiling.SpanBuffer(capacity=3)
    for i in range(5):
        buf.add(profiling.Span(f"s{i}", 1, i, i + 1, i, None, None, {}))
    assert [s.name for s in buf.spans()] == ["s2", "s3", "s4"]
    assert buf.dropped == 2


# -- the program's layers -----------------------------------------------------

@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing")
    torch.manual_seed(0)
    model = NBodyGNN(**KW)
    save_checkpoint(d / "model.pt", params=params_to_jax(model.state_dict()),
                    norm_stats={"state_mean": np.zeros(6, np.float32),
                                "state_std": np.ones(6, np.float32)},
                    model_config=KW)
    (d / "config.json").write_text(json.dumps(
        {"model_config": KW, "training_config": {"k_neighbors": K}}))
    return str(d / "model.pt"), str(d / "config.json")


def _system(seed):
    r = np.random.RandomState(seed)
    return {"positions": r.randn(N, 3).tolist(),
            "velocities": r.randn(N, 3).tolist(),
            "masses": r.uniform(1.0, 2.0, N).tolist(), "n_steps": 3,
            "trajectory": False}


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _concurrent_rollouts(paths, n_requests):
    """``n_requests`` /rollout requests at once through a CPU ReplicaPool
    and MicroBatcher over HTTP; (batcher, /metrics text)."""
    pool = build_replica_pool(*paths, n_replicas=2, device="cpu")
    batcher = MicroBatcher(pool, max_batch=4, max_wait_s=0.2)
    httpd = serve(pool, host="127.0.0.1", port=0, batcher=batcher)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    answers = [None] * n_requests
    barrier = threading.Barrier(n_requests)

    def client(i):
        barrier.wait()
        answers[i] = _post(url + "/rollout", _system(i))

    try:
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(n_requests)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert all(a is not None and len(a["positions"]) == N for a in answers)
    return batcher, text


def _series(text, name):
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
    assert m, name
    return float(m.group(1))


def test_metrics_count_queue_requests_and_json(paths):
    batcher, text = _concurrent_rollouts(paths, 4)
    assert _series(text, "nbody_batch_queue_seconds_count") == 4
    assert _series(text, "nbody_batch_queue_seconds_sum") > 0
    assert _series(text, "nbody_batch_requests_sum") == 4
    assert _series(text, "nbody_batch_requests_count") == batcher.dispatches
    assert batcher.dispatches >= 1
    for stage in ("decode", "encode"):
        assert _series(text,
                       f'nbody_json_seconds_count{{stage="{stage}"}}') == 4
        assert _series(text,
                       f'nbody_json_seconds_sum{{stage="{stage}"}}') > 0
    assert recorded_spans() == []  # the counters need no session


def test_serving_spans_share_request_ids(paths):
    """Under a session: each request's queue span lies on its handler's
    thread inside its serve.request span and ends where a dispatch's
    serve.rollout, which carries its id, starts; each rollout step holds
    its k-NN and forward spans."""
    with _session():
        _concurrent_rollouts(paths, 4)
    spans = recorded_spans()
    requests = {s.request: s for s in _by_name(spans, "serve.request")}
    assert len(requests) == 4 and None not in requests
    rollouts = _by_name(spans, "serve.rollout")
    carried = [r for s in rollouts for r in s.attrs["requests"]]
    assert sorted(carried) == sorted(requests)
    for s in rollouts:
        assert s.attrs["batch"] == len(s.attrs["requests"])
        assert s.attrs["bucket"] >= s.attrs["batch"]
    starts = {r: s.start_ns for s in rollouts for r in s.attrs["requests"]}
    queues = _by_name(spans, "serve.queue")
    assert sorted(q.request for q in queues) == sorted(requests)
    for q in queues:
        req = requests[q.request]
        assert q.thread == req.thread and q.parent == req.id
        assert req.start_ns <= q.start_ns <= q.end_ns <= req.end_ns
        assert q.end_ns <= starts[q.request]
    for name in ("serve.decode", "serve.encode"):
        assert sorted(s.request for s in _by_name(spans, name)) \
            == sorted(requests)
    steps = _by_name(spans, "predict.step")
    assert len(steps) == 3 * len(rollouts)
    ids = {s.id for s in steps}
    for name in ("predict.knn", "predict.forward"):
        children = _by_name(spans, name)
        assert len(children) == len(steps)
        assert all(c.parent in ids for c in children)
    assert len(_by_name(spans, "predict.readback")) == len(rollouts)


def _until(cond):
    deadline = time.monotonic() + 60
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.001)


def test_held_dispatch_counter_and_span(paths):
    """``nbody_batch_held_requests`` reads 0 after a lone request; with the
    device lock held (as the benchmark pauses a service) under one
    request's dispatch, the three requests that arrive meanwhile are one
    held dispatch of 3, whose serve.rollout span says ``held``."""
    service = build_service(*paths, device="cpu")
    batcher = MicroBatcher(service, max_batch=8, max_wait_s=0.01)
    httpd = serve(service, host="127.0.0.1", port=0, batcher=batcher)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def metrics():
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            return resp.read().decode()

    def client(i):
        t = threading.Thread(target=_post, args=(url + "/rollout",
                                                 _system(i)))
        t.start()
        return t

    def queued():
        with batcher._lock:
            return len(batcher._pending.get((N, 3), ()))

    try:
        with _session():
            _post(url + "/rollout", _system(0))
            for text in (batcher.render(), metrics()):
                assert _series(text, "nbody_batch_held_requests_sum") == 0
                assert _series(text, "nbody_batch_held_requests_count") == 0
            with service._lock:
                clients = [client(1)]
                _until(lambda: batcher.dispatches == 2)
                for i in (2, 3, 4):
                    clients.append(client(i))
                    _until(lambda: queued() == i - 1)
            for c in clients:
                c.join(timeout=120)
            assert not any(c.is_alive() for c in clients)
            for text in (batcher.render(), metrics()):
                assert _series(text, "nbody_batch_held_requests_sum") == 3
                assert _series(text, "nbody_batch_held_requests_count") == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    rollouts = sorted(_by_name(recorded_spans(), "serve.rollout"),
                      key=lambda s: s.start_ns)
    assert [(s.attrs["batch"], s.attrs["held"]) for s in rollouts] == [
        (1, False), (1, False), (3, True)]


def test_train_step_spans_tile_the_step():
    torch.manual_seed(0)
    model = NBodyGNN(**KW)
    pos = torch.randn(N, 3)
    step = make_train_step(model, make_optimizer(model, 1e-3, 1e-4),
                           knn_edge_index(pos, K), torch.zeros(6),
                           torch.ones(6), torch.ones(N, 1))
    states, targets = torch.randn(2, N, 6), torch.randn(2, N, 6)
    step(states, targets)
    assert recorded_spans() == []
    with _session():
        loss = step(states, targets)
    assert torch.isfinite(loss)
    spans = recorded_spans()
    outer, = _by_name(spans, "train.step")
    phases = [s for s in spans if s.parent == outer.id]
    assert [s.name for s in sorted(phases, key=lambda s: s.start_ns)] == [
        "train.forward", "train.loss", "train.backward", "train.update"]
    assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
               for s in phases)


def _cpu_step():
    torch.manual_seed(0)
    model = NBodyGNN(**{**KW, "dropout": 0.1})
    step = make_train_step(model, make_optimizer(model, 1e-3, 1e-4),
                           knn_edge_index(torch.randn(N, 3), K),
                           torch.zeros(6), torch.ones(6), torch.ones(N, 1))
    return model, step


def test_train_step_stays_eager_off_cuda():
    _, step = _cpu_step()
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.randn(2, N, 6), torch.randn(2, N, 6))
               for _ in range(3)]
    with _session():
        for s, t in batches:
            step(s, t, gen)
    assert (step.count, step.eager_steps, step.captures,
            step.graph_replays) == (3, 3, 0, 0)
    spans = recorded_spans()
    outers = _by_name(spans, "train.step")
    assert [s.attrs for s in outers] == [{"graph": "eager"}] * 3
    for outer in outers:
        assert sorted(s.name for s in spans if s.parent == outer.id) == [
            "train.backward", "train.forward", "train.loss", "train.update"]


def test_train_step_returns_a_loss_of_its_own_each_call():
    _, step = _cpu_step()
    gen = torch.Generator().manual_seed(2)
    s, t = torch.randn(2, N, 6), torch.randn(2, N, 6)
    losses = [step(s * (i + 1), t, gen) for i in range(3)]
    values = [float(x) for x in losses]
    assert len({id(x) for x in losses}) == 3
    assert len({x.data_ptr() for x in losses}) == 3
    assert len(set(values)) == 3
    step(s, t, gen)
    assert [float(x) for x in losses] == values


@pytest.mark.parametrize("replays", [0, 1, 5])
def test_captured_launches_count_each_replay_once(monkeypatch, replays):
    """One eager step, one captured step and ``replays`` replays count
    ``replays + 2`` steps' launches: the capture's rise stands for the
    replay that follows it, and each later replay is credited with it."""
    from nbody_gnn_hpc_torch import ops

    monkeypatch.setattr(ops.fused_edge_layer, "bf16_launches", 0)
    monkeypatch.setattr(ops.fused_edge_backward, "bf16_launches", 0)

    def step_launches():  # what one step's Python counts: 6 layers
        ops.fused_edge_layer.bf16_launches += 6
        ops.fused_edge_backward.bf16_launches += 6

    before = ops.launch_counts()
    step_launches()  # the eager step
    captured = ops.CapturedLaunches()
    with captured.capturing():
        step_launches()
    assert captured.rise == {"fused_edge_fwd_bf16": 6,
                             "fused_edge_bwd_bf16": 6}
    for _ in range(replays):
        captured.replayed()
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"fused_edge_fwd_bf16": 6 * (replays + 2),
                  "fused_edge_bwd_bf16": 6 * (replays + 2)}


def test_a_captured_stream_launches_on_its_graphs_arrival_counters():
    from nbody_gnn_hpc_torch.ops import arrivals_from, fused_edge

    class Stream:  # what arrivals_from reads of a torch.cuda.Stream
        cuda_stream = 7

    cpu = torch.device("cpu")
    eager = fused_edge._arrivals(cpu, 7, 10)
    owned = torch.zeros(16, dtype=torch.int32)
    with arrivals_from(owned, Stream()):
        assert fused_edge._arrivals(cpu, 7, 16) is owned
        assert fused_edge._arrivals(cpu, 8, 16) is not owned
        with pytest.raises(RuntimeError, match="arrival counters"):
            fused_edge._arrivals(cpu, 7, 17)
    assert fused_edge._arrivals(cpu, 7, 10) is eager
