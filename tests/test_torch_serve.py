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
