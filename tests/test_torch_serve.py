"""Port rollout HTTP service (nbody_gnn_hpc_torch/serve.py) on the CPU.

Mirrors the cases of tests/test_serve.py that the port covers: the real
ThreadingHTTPServer on an ephemeral port with a tiny model, driven through
urllib and through the port's client.  The port service is also held
against the JAX service on the same checkpoint.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from nbody_gnn_hpc_torch.client import RolloutClient, ServiceError
from nbody_gnn_hpc_torch.models import NBodyGNN
from nbody_gnn_hpc_torch.serve import (RolloutService, _validate,
                                       build_service, serve)
from nbody_gnn_hpc_tpu.io.model_io import save_checkpoint
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.serve import RolloutService as JaxRolloutService

N, K = 12, 4
KW = dict(node_input_dim=7, hidden_dim=8, n_layers=1, output_dim=6,
          dropout=0.0)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    params = init_model(JaxGNN(**KW), jax.random.PRNGKey(0), N, N * K)
    params = jax.tree_util.tree_map(lambda p: p + 0.01, params)
    path = tmp_path_factory.mktemp("serve") / "model.pt"
    save_checkpoint(path, params=params,
                    norm_stats={"state_mean": np.zeros(6, np.float32),
                                "state_std": np.ones(6, np.float32)},
                    model_config=KW)
    return str(path)


@pytest.fixture(scope="module")
def service(ckpt):
    return RolloutService(NBodyGNN(**KW), ckpt, k_neighbors=K, device="cpu")


@pytest.fixture(scope="module")
def httpd(service):
    httpd = serve(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)


@pytest.fixture(scope="module")
def server(httpd):
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def post_status(url, body: bytes):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _state(seed=0, b=None):
    rng = np.random.RandomState(seed)
    lead = () if b is None else (b,)
    return (rng.randn(*lead, N, 3).astype(np.float32),
            rng.randn(*lead, N, 3).astype(np.float32),
            rng.uniform(1e10, 1e12, N).astype(np.float32))


def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as resp:
        body = json.loads(resp.read())
    assert body["status"] == "ok"
    assert body["device"] == "cpu"
    assert body["model"]["k_neighbors"] == K


def test_rollout_endpoint_matches_jax_service(server, ckpt):
    pos, vel, masses = _state(0)
    out = post(f"{server}/rollout", {
        "positions": pos.tolist(), "velocities": vel.tolist(),
        "masses": masses.tolist(), "n_steps": 3})
    got = np.asarray(out["positions"])
    assert got.shape == (4, N, 3) and np.isfinite(got).all()
    want = JaxRolloutService(JaxGNN(**KW), ckpt, k_neighbors=K).rollout(
        pos, vel, masses, 3)
    np.testing.assert_allclose(got, want["positions"], rtol=1e-4, atol=1e-4)


def test_rollout_batch_endpoint(server, service):
    pos, vel, masses = _state(1, b=2)
    out = post(f"{server}/rollout_batch", {
        "positions": pos.tolist(), "velocities": vel.tolist(),
        "masses": np.stack([masses, masses * 2]).tolist(), "n_steps": 2})
    got = np.asarray(out["positions"])
    assert got.shape == (2, 3, N, 3)
    one = service.rollout(pos[1], vel[1], masses * 2, 2)
    np.testing.assert_allclose(got[1], one["positions"], rtol=1e-5,
                               atol=1e-5)


def test_rollout_final_only_and_npz_via_client(server):
    pos, vel, masses = _state(2)
    client = RolloutClient(server)  # npz transport
    full = client.rollout(pos, vel, masses, 4)
    assert full["positions"].dtype == np.float32
    assert full["positions"].shape == (5, N, 3)
    final = client.rollout(pos, vel, masses, 4, trajectory=False)
    assert final["positions"].shape == (N, 3)
    np.testing.assert_array_equal(final["positions"], full["positions"][-1])
    as_json = RolloutClient(server, fmt="json").rollout(pos, vel, masses, 4)
    np.testing.assert_allclose(as_json["positions"], full["positions"],
                               rtol=1e-6)


def test_rollout_stream_matches_buffered(server):
    pos, vel, masses = _state(3)
    client = RolloutClient(server)
    chunks = list(client.rollout_stream(pos, vel, masses, 7, chunk=3))
    assert [c["frame_start"] for c in chunks] == [0, 4, 7]
    streamed = np.concatenate([c["positions"] for c in chunks])
    np.testing.assert_array_equal(
        streamed, client.rollout(pos, vel, masses, 7)["positions"])


def test_simulate_endpoint_and_stream(server, service):
    pos, vel, masses = _state(4)
    client = RolloutClient(server)
    final = client.simulate(pos, vel, masses, 6)
    assert final["positions"].shape == (N, 3)
    traj = client.simulate(pos, vel, masses, 6, trajectory=True,
                           save_interval=2)
    assert traj["positions"].shape == (4, N, 3)
    np.testing.assert_array_equal(traj["times"].shape, (4,))
    np.testing.assert_array_equal(traj["positions"][-1], final["positions"])
    chunks = list(client.simulate_stream(pos, vel, masses, 6,
                                         save_interval=2))
    np.testing.assert_array_equal(
        np.concatenate([c["positions"] for c in chunks]), traj["positions"])


def test_simulate_chunking_preserves_save_cadence(service, monkeypatch):
    """SIM_CHUNK boundaries (and intervals longer than a chunk) give the
    frames of one unchunked trajectory."""
    pos, vel, masses = _state(5)
    whole = service.simulate(pos, vel, masses, 10, trajectory=True,
                             save_interval=2)
    monkeypatch.setattr(service, "SIM_CHUNK", 3)
    for interval, n_steps in ((2, 10), (4, 10)):
        chunked = service.simulate(pos, vel, masses, n_steps,
                                   trajectory=True, save_interval=interval)
        step = interval // 2
        np.testing.assert_allclose(chunked["positions"],
                                   whole["positions"][::step], rtol=1e-6)
        np.testing.assert_allclose(chunked["times"], whole["times"][::step],
                                   rtol=1e-6)


MALFORMED = [b"not json", b"{}", b'{"positions": [[1,2,3]]}',
             json.dumps({"positions": [[0, 0, 0]] * N,
                         "velocities": [[0, 0, 0]] * N,
                         "masses": [1.0] * N, "n_steps": True}).encode(),
             json.dumps({"positions": [[0, 0, 0]] * N,
                         "velocities": [[0, 0, 0]] * N,
                         "masses": [1.0] * N, "n_steps": 2,
                         "format": "xml"}).encode(),
             json.dumps({"positions": [[0, 0, 0]] * N,
                         "velocities": [[0, 0, 0]] * N,
                         "masses": [1.0] * N, "n_steps": 2,
                         "trajectory": "yes"}).encode()]


@pytest.mark.parametrize("body", MALFORMED)
def test_bad_request_is_400_and_server_survives(server, body):
    status, out = post_status(f"{server}/rollout", body)
    assert status == 400 and "error" in out
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as resp:
        assert resp.status == 200


def test_stream_validation_and_unknown_path(server):
    pos, vel, masses = _state(6)
    base = {"positions": pos.tolist(), "velocities": vel.tolist(),
            "masses": masses.tolist(), "n_steps": 3, "stream": True}
    for extra in ({"format": "npz"}, {"chunk": 0}, {"stream": 1}):
        status, _ = post_status(f"{server}/rollout",
                                json.dumps({**base, **extra}).encode())
        assert status == 400
    status, _ = post_status(
        f"{server}/rollout_batch",
        json.dumps({**base, "positions": [pos.tolist()],
                    "velocities": [vel.tolist()]}).encode())
    assert status == 400
    status, _ = post_status(f"{server}/nope", b"{}")
    assert status == 404
    with pytest.raises(ServiceError) as err:
        RolloutClient(server).simulate(pos, vel, masses, 3, save_interval=5)
    assert err.value.status == 400


def test_metrics_endpoint(server):
    urllib.request.urlopen(f"{server}/healthz", timeout=30).read()
    with urllib.request.urlopen(f"{server}/metrics", timeout=30) as resp:
        text = resp.read().decode()
    assert 'nbody_requests_total{endpoint="/healthz",status="200"}' in text
    assert "nbody_request_seconds_bucket" in text
    assert "nbody_uptime_seconds" in text


def test_simulate_trajectory_frame_cap(server):
    pos, vel, masses = _state(7)
    status, out = post_status(f"{server}/simulate", json.dumps({
        "positions": pos.tolist(), "velocities": vel.tolist(),
        "masses": masses.tolist(), "n_steps": 4001,
        "trajectory": True}).encode())
    assert status == 400 and "4000" in out["error"]


def test_validate_shapes():
    pos, vel, masses = _state(8, b=2)
    _validate({"positions": pos, "velocities": vel,
               "masses": np.stack([masses] * 2), "n_steps": 1}, True)
    with pytest.raises(ValueError, match="shape mismatch"):
        _validate({"positions": pos, "velocities": vel, "masses": masses[:3],
                   "n_steps": 1}, True)
    with pytest.raises(ValueError, match="non-finite"):
        _validate({"positions": pos * np.nan, "velocities": vel,
                   "masses": masses, "n_steps": 1}, True)


def test_build_service_reads_config(tmp_path, ckpt):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"model_config": {**KW, "dtype": "bfloat16",
                                                "edge_impl": "auto"},
                               "training_config": {"k_neighbors": 3}}))
    svc = build_service(ckpt, str(cfg), device="cpu")
    assert svc.model_info["k_neighbors"] == 3
    assert svc.predictor.model.hidden_dim == KW["hidden_dim"]
    svc.warmup(N, 2)


def test_build_service_reads_edge_impl_and_quantize(tmp_path, ckpt, service):
    """``edge_impl: "fused_full"`` in the config serves through the
    whole-layer function (the same rollout to float32 summation order), and
    ``quantize`` shows in ``model_info`` and tracks the float32 service."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"model_config": {**KW,
                                                "edge_impl": "fused_full"},
                               "training_config": {"k_neighbors": K}}))
    full = build_service(ckpt, str(cfg), device="cpu")
    assert full.model_info["edge_impl"] == "fused_full"
    assert full.model_info["quantization"] is None
    assert service.model_info["edge_impl"] == "fused"
    pos, vel, masses = _state(9)
    a = full.rollout(pos, vel, masses, 5)["positions"]
    b = service.rollout(pos, vel, masses, 5)["positions"]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    quant = build_service(ckpt, str(cfg), device="cpu", quantize="int8")
    assert quant.model_info["quantization"] == "int8"
    c = quant.rollout(pos, vel, masses, 5)["positions"]
    rel = np.sqrt(np.mean((c - b) ** 2)) / np.sqrt(np.mean(b ** 2))
    assert 0 < rel < 5e-2, rel
    cfg.write_text(json.dumps({"model_config": {**KW, "edge_impl": "mxu"}}))
    with pytest.raises(ValueError, match="edge_impl"):
        build_service(ckpt, str(cfg), device="cpu")


# -- micro-batching ----------------------------------------------------------
# The behaviour cases of tests/test_serve.py, each run on the port's
# MicroBatcher and on the JAX package's with the same stub service: the two
# must coalesce, pad, slice and fail alike.

def _batcher_classes():
    from nbody_gnn_hpc_torch.serve import MicroBatcher
    from nbody_gnn_hpc_tpu.serve import MicroBatcher as JaxMicroBatcher

    return {"port": MicroBatcher, "jax": JaxMicroBatcher}


@pytest.fixture(params=["port", "jax"])
def batcher_cls(request):
    return _batcher_classes()[request.param]


class _StubService:
    """Counts rollout_batch dispatches; the result is a pure function of
    the inputs, so slicing and padding can be checked exactly: frame t of
    the (B, n_steps+1, N, 3) trajectory is pos+t."""

    def __init__(self, fail=False):
        self.calls = []
        self.trajs = []
        self.fail = fail
        self._lock = threading.Lock()

    def rollout_batch(self, pos, vel, masses, n_steps, trajectory=True):
        with self._lock:
            self.calls.append(pos.shape[0])
            self.trajs.append(trajectory)
        if self.fail:
            raise RuntimeError("boom")
        p_final = pos + n_steps
        v_final = vel + masses[..., None]
        if not trajectory:
            return {"positions": p_final, "velocities": v_final}
        return {"positions": np.stack([pos + t
                                       for t in range(n_steps + 1)], 1),
                "velocities": np.stack([v_final] * (n_steps + 1), 1)}


def _job(seed, n=6):
    r = np.random.RandomState(seed)
    return (r.randn(n, 3).astype(np.float32),
            r.randn(n, 3).astype(np.float32),
            r.uniform(1.0, 2.0, n).astype(np.float32))


def _fire(batcher, jobs, n_steps=3, trajectory=None):
    """``batcher.rollout`` at once for each (pos, vel, masses) job;
    ``n_steps`` and ``trajectory`` are one value or one per job."""
    results, errors = [None] * len(jobs), [None] * len(jobs)
    barrier = threading.Barrier(len(jobs))
    steps = n_steps if isinstance(n_steps, list) else [n_steps] * len(jobs)

    def work(i):
        kw = {} if trajectory is None else {"trajectory": trajectory[i]}
        barrier.wait()
        try:
            results[i] = batcher.rollout(*jobs[i], steps[i], **kw)
        except Exception as e:  # noqa: BLE001 - recorded for assertions
            errors[i] = e

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return results, errors


def test_micro_batcher_coalesces_and_pads(batcher_cls):
    stub = _StubService()
    batcher = batcher_cls(stub, max_batch=4, max_wait_s=0.4)
    assert batcher.buckets == (1, 2, 4)
    jobs = [_job(s) for s in range(3)]
    results, errors = _fire(batcher, jobs)
    assert errors == [None] * 3
    assert stub.calls == [4]  # one dispatch, padded to the 4-bucket
    for job, res in zip(jobs, results):
        assert res["positions"].shape == (4, 6, 3)
        np.testing.assert_array_equal(res["positions"][-1], job[0] + 3)
        np.testing.assert_array_equal(res["velocities"][-1],
                                      job[1] + job[2][:, None])


def test_micro_batcher_single_request_uses_smallest_bucket(batcher_cls):
    stub = _StubService()
    batcher = batcher_cls(stub, max_batch=4, max_wait_s=0.01)
    res = batcher.rollout(*_job(9), 2)
    assert stub.calls == [1]
    np.testing.assert_array_equal(res["positions"][-1], _job(9)[0] + 2)


def test_micro_batcher_distinct_keys_do_not_coalesce(batcher_cls):
    stub = _StubService()
    batcher = batcher_cls(stub, max_batch=4, max_wait_s=0.15)
    jobs = [_job(1), _job(2)]
    results, errors = _fire(batcher, jobs, n_steps=[5, 7])
    assert errors == [None] * 2
    assert sorted(stub.calls) == [1, 1]
    np.testing.assert_array_equal(results[0]["positions"][-1],
                                  jobs[0][0] + 5)
    np.testing.assert_array_equal(results[1]["positions"][-1],
                                  jobs[1][0] + 7)


def test_micro_batcher_error_propagates_to_every_waiter(batcher_cls):
    stub = _StubService(fail=True)
    batcher = batcher_cls(stub, max_batch=4, max_wait_s=0.2)
    results, errors = _fire(batcher, [_job(s) for s in range(3)])
    assert results == [None] * 3
    assert all(isinstance(e, RuntimeError) for e in errors)
    stub.fail = False  # the batcher is reusable after a failed dispatch
    res = batcher.rollout(*_job(7), 1)
    np.testing.assert_array_equal(res["positions"][-1], _job(7)[0] + 1)


def test_micro_batcher_mixed_trajectory_flags(batcher_cls):
    stub = _StubService()
    batcher = batcher_cls(stub, max_batch=4, max_wait_s=0.4)
    jobs = [_job(0), _job(1), _job(2)]
    results, errors = _fire(batcher, jobs, trajectory=[True, False, True])
    assert errors == [None] * 3
    assert stub.calls == [4] and stub.trajs == [True]
    assert results[0]["positions"].shape == (4, 6, 3)
    assert results[1]["positions"].shape == (6, 3)  # final state only
    np.testing.assert_array_equal(results[1]["positions"], jobs[1][0] + 3)
    np.testing.assert_array_equal(results[2]["positions"][-1],
                                  jobs[2][0] + 3)


def test_micro_batcher_all_final_only_keeps_no_trajectory(batcher_cls):
    stub = _StubService()
    batcher = batcher_cls(stub, max_batch=4, max_wait_s=0.4)
    jobs = [_job(s) for s in range(2)]
    results, errors = _fire(batcher, jobs, n_steps=2,
                            trajectory=[False, False])
    assert errors == [None] * 2
    assert stub.trajs == [False]
    for job, res in zip(jobs, results):
        assert res["positions"].shape == (6, 3)
        np.testing.assert_array_equal(res["positions"], job[0] + 2)


def test_micro_batcher_non_power_of_two_cap_no_deadlock(batcher_cls):
    stub = _StubService()
    batcher = batcher_cls(stub, max_batch=6, max_wait_s=0.4)
    assert batcher.buckets == (1, 2, 4, 6)
    jobs = [_job(s) for s in range(5)]
    results, errors = _fire(batcher, jobs)
    assert errors == [None] * 5
    assert stub.calls == [6]  # one padded dispatch, not a hang
    for job, res in zip(jobs, results):
        np.testing.assert_array_equal(res["positions"][-1], job[0] + 3)


def test_micro_batcher_overflow_drains_in_capped_chunks(batcher_cls):
    stub = _StubService()
    batcher = batcher_cls(stub, max_batch=4, max_wait_s=0.3)
    jobs = [_job(s) for s in range(7)]
    results, errors = _fire(batcher, jobs)
    assert errors == [None] * 7
    assert all(c <= 4 for c in stub.calls) and sum(stub.calls) >= 7
    for job, res in zip(jobs, results):
        np.testing.assert_array_equal(res["positions"][-1], job[0] + 3)


def test_micro_batcher_drained_keys_are_dropped(batcher_cls):
    stub = _StubService()
    batcher = batcher_cls(stub, max_batch=4, max_wait_s=0.05)
    for steps in (1, 2, 3):
        batcher.rollout(*_job(steps), steps)  # three distinct shape keys
    _, errors = _fire(batcher, [_job(s) for s in range(3)])
    assert errors == [None] * 3
    assert batcher._pending == {}


def test_micro_batcher_counts_dispatches_and_warms_every_bucket():
    from nbody_gnn_hpc_torch.serve import MicroBatcher

    class _Warm(_StubService):
        def __init__(self):
            super().__init__()
            self.warmed = []

        def warmup(self, n, steps, batch=None):
            self.warmed.append((n, steps, batch))

    stub = _Warm()
    batcher = MicroBatcher(stub, max_batch=6, max_wait_s=0.2)
    batcher.warmup(12, 5)
    assert stub.warmed == [(12, 5, b) for b in (1, 2, 4, 6)]
    _fire(batcher, [_job(s) for s in range(3)])
    batcher.rollout(*_job(5), 2)
    assert batcher.dispatches == len(stub.calls) == 2


@pytest.fixture(scope="module")
def batched_server(service):
    from nbody_gnn_hpc_torch.serve import MicroBatcher

    batcher = MicroBatcher(service, max_batch=4, max_wait_s=0.2)
    httpd = serve(service, host="127.0.0.1", port=0, batcher=batcher)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", batcher
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)


def test_batched_server_concurrent_rollouts_match_direct(batched_server,
                                                         service):
    """Concurrent /rollout requests through the MicroBatcher return what
    direct single-system calls return (batch rows are independent; float32
    reduction shapes differ: 1e-5)."""
    url, batcher = batched_server
    jobs = [_state(20 + i) for i in range(3)]
    jobs = [(p, v, m * (1 + i)) for i, (p, v, m) in enumerate(jobs)]
    results = [None] * 3
    barrier = threading.Barrier(3)
    before = batcher.dispatches

    def work(i):
        barrier.wait()
        results[i] = post(f"{url}/rollout", {
            "positions": jobs[i][0].tolist(),
            "velocities": jobs[i][1].tolist(),
            "masses": jobs[i][2].tolist(), "n_steps": 3,
            "trajectory": i != 1})

    threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert 1 <= batcher.dispatches - before < 3  # coalesced
    for i, (job, res) in enumerate(zip(jobs, results)):
        want = service.rollout(*job, 3)["positions"]
        got = np.asarray(res["positions"], np.float32)
        np.testing.assert_allclose(got, want if i != 1 else want[-1],
                                   rtol=1e-5, atol=1e-5)


# -- backpressure (max_inflight) ---------------------------------------------

class _SlowService:
    STREAM_CHUNK = 64
    device = "stub"
    model_info = {"stub": True}

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()

    def rollout(self, pos, vel, masses, n_steps, trajectory=True):
        self.started.set()
        assert self.release.wait(30)
        return {"positions": pos[None], "velocities": vel[None]}


def test_max_inflight_sheds_excess_with_503():
    """Beyond max_inflight compute requests the server sheds with 503 +
    Retry-After; /healthz and /metrics answer during saturation; the shed
    request shows in /metrics.  The gate is released after the response
    has been written, so right after the slow client returns a fresh
    request may still meet a 503: it is retried for a bounded time."""
    import time

    svc = _SlowService()
    httpd = serve(svc, host="127.0.0.1", port=0, max_inflight=1)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = json.dumps({"positions": [[0.0, 0.0, 0.0]] * 4,
                       "velocities": [[0.0, 0.0, 0.0]] * 4,
                       "masses": [1.0] * 4, "n_steps": 2}).encode()
    slow = {}
    done = threading.Event()

    def slow_client():
        slow["status"], slow["out"] = post_status(f"{url}/rollout", body)
        done.set()

    try:
        client = threading.Thread(target=slow_client)
        client.start()
        assert svc.started.wait(30)  # the first request holds the gate
        assert httpd.inflight.count() == 1

        t0 = time.monotonic()
        req = urllib.request.Request(
            f"{url}/rollout", data=body,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=60)
        assert exc.value.code == 503
        assert exc.value.headers["Retry-After"] == "1"
        assert "max_inflight" in exc.value.read().decode()
        assert time.monotonic() - t0 < 5  # shed, not queued

        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        text, deadline = "", time.monotonic() + 5
        while 'endpoint="/rollout",status="503"' not in text \
                and time.monotonic() < deadline:
            with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
                text = r.read().decode()
            time.sleep(0.05)
        assert 'endpoint="/rollout",status="503"' in text

        svc.release.set()
        assert done.wait(30)
        client.join(timeout=30)
        assert slow["status"] == 200, slow
        status, deadline = 503, time.monotonic() + 10
        while status == 503 and time.monotonic() < deadline:
            status, out = post_status(f"{url}/rollout", body)
            if status == 503:
                time.sleep(0.02)
        assert status == 200  # capacity freed
        assert np.asarray(out["positions"]).shape[0] == 1
    finally:
        svc.release.set()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def test_no_gate_without_max_inflight(server):
    """Without ``max_inflight`` nothing is shed: concurrent requests all
    answer 200."""
    pos, vel, masses = _state(30)
    body = json.dumps({"positions": pos.tolist(), "velocities": vel.tolist(),
                       "masses": masses.tolist(), "n_steps": 2}).encode()
    codes = [None] * 4

    def work(i):
        codes[i] = post_status(f"{server}/rollout", body)[0]

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert codes == [200] * 4


# -- replica pool ------------------------------------------------------------

@pytest.fixture(scope="module")
def pool_paths(ckpt, tmp_path_factory):
    cfg = tmp_path_factory.mktemp("pool") / "config.json"
    cfg.write_text(json.dumps({"model_config": KW,
                               "training_config": {"k_neighbors": K}}))
    return ckpt, str(cfg)


def _pool(pool_paths, n):
    from nbody_gnn_hpc_torch.serve import build_replica_pool

    return build_replica_pool(*pool_paths, n_replicas=n, device="cpu")


def test_pool_matches_single_service_and_jax_pool(pool_paths, service):
    """Every endpoint through the pool equals the single service exactly
    (replicas are copies of one model), and the JAX package's pool on the
    same checkpoint to 1e-4."""
    from nbody_gnn_hpc_tpu.serve import \
        build_replica_pool as jax_build_replica_pool

    pool = _pool(pool_paths, 2)
    assert pool.model_info["replicas"] == 2
    assert pool.device == "cpu:0, cpu:1"
    pos, vel, m = _state(11)
    for kwargs in ({}, {"trajectory": False}):
        np.testing.assert_array_equal(
            pool.rollout(pos, vel, m, 4, **kwargs)["positions"],
            service.rollout(pos, vel, m, 4, **kwargs)["positions"])
    both = (np.stack([pos, pos]), np.stack([vel, vel]), m)
    np.testing.assert_array_equal(
        pool.rollout_batch(*both, 3)["positions"],
        service.rollout_batch(*both, 3)["positions"])
    np.testing.assert_array_equal(
        pool.simulate(pos, vel, m, 6, dt=1e-3, trajectory=True,
                      save_interval=2)["positions"],
        service.simulate(pos, vel, m, 6, dt=1e-3, trajectory=True,
                         save_interval=2)["positions"])
    stream = np.concatenate([c["positions"] for c in
                             pool.rollout_stream(pos, vel, m, 5, chunk=2)])
    full = service.rollout(pos, vel, m, 5)["positions"]
    np.testing.assert_array_equal(stream, full)
    jpool = jax_build_replica_pool(*pool_paths, n_replicas=2)
    np.testing.assert_allclose(jpool.rollout(pos, vel, m, 5)["positions"],
                               full, rtol=1e-4, atol=1e-4)


def test_pool_replicas_own_their_model_and_lock(pool_paths):
    pool = _pool(pool_paths, 3)
    models = {id(s.predictor.model) for s in pool.services}
    locks = {id(s._lock) for s in pool.services}
    weights = {s.predictor.model.decoder_0.weight.data_ptr()
               for s in pool.services}
    assert len(models) == len(locks) == len(weights) == 3
    assert pool.model_info["replicas"] == 3


def test_pool_concurrent_requests_fan_out(pool_paths):
    """Requests in flight at once run on distinct replicas: each replica's
    rollout is held at a barrier that only two concurrent calls pass."""
    pool = _pool(pool_paths, 2)
    used = []
    inside = threading.Barrier(2)
    for svc in pool.services:
        def wrapped(*a, _svc=svc, _real=svc.rollout, **k):
            used.append(_svc.device)
            inside.wait(timeout=30)  # both replicas are busy here
            return _real(*a, **k)
        svc.rollout = wrapped
    pos, vel, m = _state(12)
    results = [None] * 4

    def work(i):
        results[i] = pool.rollout(pos, vel, m, 2)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(r is not None for r in results)
    assert sorted(used) == ["cpu:0", "cpu:0", "cpu:1", "cpu:1"]
    assert pool._free.qsize() == 2  # every replica came back


def test_pool_rollout_stream_balances_across_replicas(pool_paths):
    pool = _pool(pool_paths, 2)
    used = []
    for svc in pool.services:
        def wrapped(*a, _svc=svc, _real=svc.predictor.predict_rollout, **k):
            used.append(_svc.device)
            return _real(*a, **k)
        svc.predictor.predict_rollout = wrapped
    pos, vel, m = _state(13)
    it = pool.rollout_stream(pos, vel, m, 6, chunk=3)
    next(it)
    assert pool._free.qsize() == 2  # returned between chunks
    it.close()
    assert pool._free.qsize() == 2
    used.clear()
    chunks = list(pool.rollout_stream(pos, vel, m, 6, chunk=3))
    assert len(chunks) == 2 and len(set(used)) == 2, used
    assert pool._free.qsize() == 2


def test_pool_simulate_stream_pins_one_replica(pool_paths, monkeypatch):
    pool = _pool(pool_paths, 2)
    for s in pool.services:
        monkeypatch.setattr(s, "SIM_CHUNK", 4)  # several chunks
    pos, vel, m = _state(14)
    it = pool.simulate_stream(pos, vel, m, 12, dt=1e-3, save_interval=2)
    next(it)
    assert pool._free.qsize() == 1  # pinned mid-stream
    it.close()
    assert pool._free.qsize() == 2  # abandonment releases
    list(pool.simulate_stream(pos, vel, m, 8, dt=1e-3, save_interval=2))
    assert pool._free.qsize() == 2  # exhaustion releases


def test_pool_through_http_server(pool_paths):
    pool = _pool(pool_paths, 2)
    httpd = serve(pool, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["model"]["replicas"] == 2
        assert health["model"]["quantization"] is None
        pos, vel, m = _state(15)
        out = post(f"{url}/rollout", {
            "positions": pos.tolist(), "velocities": vel.tolist(),
            "masses": m.tolist(), "n_steps": 3})
        assert np.asarray(out["positions"]).shape == (4, N, 3)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def test_pool_validation(pool_paths, monkeypatch):
    import torch

    from nbody_gnn_hpc_torch.serve import ReplicaPool, build_replica_pool

    with pytest.raises(ValueError):
        build_replica_pool(*pool_paths, n_replicas=0, device="cpu")
    with pytest.raises(ValueError):
        ReplicaPool([])
    assert build_replica_pool(*pool_paths, device="cpu"
                              ).model_info["replicas"] == 1
    # On the GPU the pool is bounded by the cards there are.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="2 GPUs"):
        build_replica_pool(*pool_paths, n_replicas=3)


def test_micro_batcher_overflow_fans_out_across_pool(batcher_cls):
    """Overflow chunks dispatch at once: over a pool each takes its own
    replica.  The stubs hold a dispatch for a while and record how many are
    in flight; however the four arrivals split between leaders, two
    dispatches overlap, one on each replica (a drain one after the other
    would never have two in flight)."""
    import time

    from nbody_gnn_hpc_torch.serve import ReplicaPool

    guard = threading.Lock()
    in_flight = {"now": 0, "peak": 0}

    class _Stub(_StubService):
        STREAM_CHUNK = 64

        def __init__(self, name):
            super().__init__()
            self.device = name
            self.model_info = {"stub": name}

        def rollout_batch(self, *a, **k):
            with guard:
                in_flight["now"] += 1
                in_flight["peak"] = max(in_flight["peak"], in_flight["now"])
            time.sleep(0.3)
            with guard:
                in_flight["now"] -= 1
            return super().rollout_batch(*a, **k)

    stubs = [_Stub("cpu:0"), _Stub("cpu:1")]
    batcher = batcher_cls(ReplicaPool(stubs), max_batch=2, max_wait_s=0.4)
    jobs = [_job(s) for s in range(4)]
    results, errors = _fire(batcher, jobs)
    assert errors == [None] * 4
    assert in_flight["peak"] == 2
    assert all(s.calls and max(s.calls) <= 2 for s in stubs)
    for job, res in zip(jobs, results):
        np.testing.assert_array_equal(res["positions"][-1], job[0] + 3)


def test_serve_cli_flags(pool_paths, monkeypatch):
    """The deployment flags reach build_replica_pool, MicroBatcher and
    serve."""
    import nbody_gnn_hpc_torch.serve as serve_mod

    seen = {}

    class _Httpd:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def shutdown(self):
            seen["shutdown"] = True

        def server_close(self):
            pass

        class inflight:  # noqa: N801
            @staticmethod
            def count():
                return 0

    def fake_serve(service, host, port, batcher, max_inflight):
        seen.update(service=service, batcher=batcher,
                    max_inflight=max_inflight)
        return _Httpd()

    monkeypatch.setattr(serve_mod, "serve", fake_serve)
    serve_mod.main(["-m", pool_paths[0], "-c", pool_paths[1], "--device",
                    "cpu", "--replicas", "2", "--micro-batch", "6",
                    "--micro-batch-wait-ms", "2", "--max-inflight", "5",
                    "--quantize", "int8", "--warm-particles", str(N),
                    "--warm-steps", "2", "--warm-batch", "2",
                    "--grace-period", "0.1"])
    assert seen["service"].model_info["replicas"] == 2
    assert seen["service"].model_info["quantization"] == "int8"
    assert seen["batcher"].buckets == (1, 2, 4, 6)
    assert seen["batcher"].max_wait_s == pytest.approx(0.002)
    assert seen["max_inflight"] == 5 and seen["shutdown"]
