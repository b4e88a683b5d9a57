"""The port's rollout-aware checkpoint selection (nbody_gnn_hpc_torch/
predict/selection.py and the select_checkpoint command), case for case as
tests/test_selection.py holds the JAX package's, plus the scores of both
packages on the same files and states, on the CPU."""

import json

import jax
import numpy as np
import pytest

from nbody_gnn_hpc_torch import select_checkpoint as cli
from nbody_gnn_hpc_torch.io import CheckpointManager, save_checkpoint
from nbody_gnn_hpc_torch.models import NBodyGNN
from nbody_gnn_hpc_torch.predict import (Predictor, discover_checkpoints,
                                         quantize_checkpoint,
                                         score_checkpoints, select_checkpoint)
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.predict import selection as jselection

N, K, HID = 10, 4, 16
KW = dict(node_input_dim=7, hidden_dim=HID, n_layers=2, output_dim=6,
          dropout=0.0)


@pytest.fixture(scope="module")
def model():
    return NBodyGNN(**KW)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two checkpoints sharing norm stats: zero-init (identity rollout) and
    a noise-perturbed copy (non-zero deltas), plus one with other stats."""
    d = tmp_path_factory.mktemp("sel_ckpts")
    stats = {"state_mean": np.zeros(6, np.float32),
             "state_std": np.ones(6, np.float32)}
    params = init_model(JaxGNN(**KW), jax.random.PRNGKey(0), N, N * K)
    noisy = jax.tree_util.tree_map(
        lambda leaf: leaf + 0.1 * np.random.RandomState(7).randn(
            *leaf.shape).astype(np.asarray(leaf).dtype), params)
    paths = [d / "checkpoint_epoch_10.pt", d / "best_model.pt"]
    save_checkpoint(paths[0], params=params, norm_stats=stats)
    save_checkpoint(paths[1], params=noisy, norm_stats=stats)
    other_stats = {"state_mean": np.full(6, 0.5, np.float32),
                   "state_std": np.full(6, 2.0, np.float32)}
    save_checkpoint(d / "final_model.pt", params=params,
                    norm_stats=other_stats)
    return d, paths


@pytest.fixture(scope="module")
def val_states():
    """(S=2, T=12, N, 6) trajectories constant in time: the identity
    (zero-init) model scores ~0 rollout error on them."""
    state = np.random.RandomState(3).randn(2, 1, N, 6).astype(np.float32)
    return np.repeat(state, 12, axis=1)


def _score(model, paths, val_states, masses, **kw):
    return score_checkpoints(model, paths, val_states, masses,
                             device="cpu", **kw)


def test_identity_beats_perturbed(model, ckpts, val_states):
    _, paths = ckpts
    masses = np.random.RandomState(1).uniform(1e10, 1e12, N).astype(
        np.float32)
    beats = []
    scores = _score(model, paths, val_states, masses, k_neighbors=K,
                    horizon=5, start_step=2,
                    progress_cb=lambda: beats.append(1))
    # one stall-watchdog beat per fully scored checkpoint
    assert len(beats) == len(paths)
    assert [s["path"] for s in scores] == [str(p) for p in paths]
    assert scores[0]["position_rmse"] < 1e-3          # identity: ~exact
    assert scores[1]["position_rmse"] > scores[0]["position_rmse"]
    assert select_checkpoint(scores)["path"] == str(paths[0])


def test_different_norm_stats_rescore_cleanly(model, ckpts, val_states):
    """A checkpoint with other norm stats after the first still scores
    finite, with its own stats."""
    d, paths = ckpts
    masses = np.full(N, 1e11, np.float32)
    scores = _score(model, [paths[0], d / "final_model.pt"], val_states,
                    masses, k_neighbors=K, horizon=4, start_step=0)
    assert all(np.isfinite(s["position_rmse"]) for s in scores)


def test_mixed_quantized_checkpoints_rescore_cleanly(model, ckpts,
                                                     val_states, tmp_path):
    """An int8 serving checkpoint between float32 ones scores close to its
    float32 source, and the float32 file after it is read in full."""
    _, paths = ckpts
    q = tmp_path / "best_model.int8.pt"
    quantize_checkpoint(str(paths[1]), str(q), "int8")
    masses = np.full(N, 1e11, np.float32)
    scores = _score(model, [paths[1], q, paths[0]], val_states, masses,
                    k_neighbors=K, horizon=4, start_step=0)
    assert all(np.isfinite(s["position_rmse"]) for s in scores)
    # int8 tracks its f32 source, not the identity checkpoint
    f32, int8, ident = (s["position_rmse"] for s in scores)
    assert abs(int8 - f32) < 0.5 * abs(f32 - ident) + 1e-6
    assert ident < 1e-3


def test_discover_orders_epochs_then_named(ckpts):
    d, _ = ckpts
    found = [p.name for p in discover_checkpoints(d)]
    assert found == ["checkpoint_epoch_10.pt", "best_model.pt",
                     "final_model.pt"]


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_select_rejects_nan_and_inf(bad):
    scores = [{"path": "a", "position_rmse": bad},
              {"path": "b", "position_rmse": 5.0}]
    assert select_checkpoint(scores)["path"] == "b"


def test_horizon_bounds_checked(model, ckpts, val_states):
    _, paths = ckpts
    masses = np.full(N, 1e11, np.float32)
    with pytest.raises(ValueError, match="horizon"):
        _score(model, paths, val_states, masses, k_neighbors=K, horizon=50,
               start_step=5)


def test_default_horizon_is_full(model, ckpts, val_states):
    """horizon=None scores at T - start_step - 1."""
    _, paths = ckpts
    masses = np.full(N, 1e11, np.float32)
    full = _score(model, [paths[0]], val_states, masses, k_neighbors=K,
                  start_step=2)
    explicit = _score(model, [paths[0]], val_states, masses, k_neighbors=K,
                      horizon=val_states.shape[1] - 3, start_step=2)
    assert full[0]["position_rmse"] == explicit[0]["position_rmse"]


def test_file_without_norm_stats_is_skipped_unloaded(model, ckpts,
                                                     val_states, tmp_path,
                                                     monkeypatch):
    _, paths = ckpts
    bare = tmp_path / "checkpoint_epoch_3.pt"
    save_checkpoint(bare, params=init_model(JaxGNN(**KW),
                                            jax.random.PRNGKey(1), N, N * K))
    loaded = []
    real = Predictor.load_model
    monkeypatch.setattr(Predictor, "load_model", lambda self, p: (
        loaded.append(p), real(self, p))[1])
    with pytest.warns(UserWarning, match="no norm_stats"):
        scores = _score(model, [bare, paths[0]], val_states,
                        np.full(N, 1e11, np.float32), k_neighbors=K,
                        horizon=3)
    assert loaded == [str(paths[0])]
    assert scores[0]["position_rmse"] == float("inf")
    assert scores[0]["skipped"] == "no norm_stats"
    assert select_checkpoint(scores)["path"] == str(paths[0])


def _drifting_states(s=3, t=10, seed=5):
    rng = np.random.RandomState(seed)
    pos0 = 3 * rng.randn(s, 1, N, 3)
    vel = 0.1 * rng.randn(s, 1, N, 3)
    steps = np.arange(t)[None, :, None, None]
    return np.concatenate([pos0 + vel * steps, np.broadcast_to(
        vel, (s, t, N, 3))], -1).astype(np.float32)


@pytest.mark.parametrize("k", [K, None])
def test_scores_match_jax(model, ckpts, k):
    """The same files and states through both packages: 1e-4 relative."""
    d, paths = ckpts
    candidates = paths + [d / "final_model.pt"]
    states = _drifting_states()
    masses = np.random.RandomState(2).uniform(1e10, 1e11, N).astype(
        np.float32)
    got = _score(model, candidates, states, masses, k_neighbors=k,
                 start_step=1)
    want = jselection.score_checkpoints(JaxGNN(**KW), candidates, states,
                                        masses, k, start_step=1)
    assert [g["path"] for g in got] == [w["path"] for w in want]
    for g, w in zip(got, want):
        for key in ("position_rmse", "velocity_rmse"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4)


# -- the command -------------------------------------------------------------


def test_cli_report_and_promote(ckpts, tmp_path):
    """The validation split (the first --n-sims of the last 20 % of the
    names), the report with the JAX script's keys, --promote."""
    d, paths = ckpts
    models_dir = tmp_path / "models"
    models_dir.mkdir()
    for p in paths:
        (models_dir / p.name).write_bytes(p.read_bytes())
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_config": dict(KW, edge_impl="auto"),
                   "training_config": {"k_neighbors": K}}, f)
    states = _drifting_states(s=10, t=8)
    masses = np.full(N, 1e11, np.float32)
    mgr = CheckpointManager(str(tmp_path / "data" / "checkpoints"))
    for i, tr in enumerate(states):
        mgr.save_trajectory([dict(positions=s[:, :3], velocities=s[:, 3:],
                                  accelerations=np.zeros((N, 3)),
                                  masses=masses) for s in tr],
                            f"sim_{i:04d}")
    assert cli.main(["--device", "cpu", "-m", str(models_dir),
                     "-c", str(tmp_path / "config.json"),
                     "-d", str(tmp_path / "data"), "--n-sims", "1",
                     "--start-step", "2", "--promote"]) == 0
    with open(models_dir / "checkpoint_selection.json") as f:
        report = json.load(f)
    assert set(report) == {"metric", "horizon", "start_step", "val_sims",
                           "scores", "selected"}
    assert report["val_sims"] == ["sim_0008"]
    assert report["horizon"] == 8 - 2 - 1 and report["start_step"] == 2
    assert report["metric"] == "position_rmse"
    assert [s["path"] for s in report["scores"]] == [
        str(models_dir / p.name) for p in paths]
    best = min(report["scores"], key=lambda s: s["position_rmse"])
    assert report["selected"] == best["path"]
    assert (models_dir / "selected_model.pt").read_bytes() == \
        open(best["path"], "rb").read()
    out = tmp_path / "elsewhere.json"
    assert cli.main(["--device", "cpu", "-m", str(models_dir),
                     "-c", str(tmp_path / "config.json"),
                     "-d", str(tmp_path / "data"), "-k", "2",
                     "-o", str(out)]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["horizon"] == 2
    assert report["val_sims"] == ["sim_0008", "sim_0009"]


def test_cli_without_checkpoints_or_trajectories_fails(tmp_path, ckpts):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_config": KW}, f)
    args = ["--device", "cpu", "-c", str(tmp_path / "config.json"),
            "-d", str(tmp_path / "data")]
    assert cli.main(args + ["-m", str(tmp_path)]) == 1
    assert cli.main(args + ["-m", str(ckpts[0])]) == 1
