"""Port Predictor (nbody_gnn_hpc_torch/predict) against the JAX Predictor.

Both load the same JAX checkpoint (a small model written here, and the
committed production checkpoint) and roll out the same numpy states.
Tolerances: f32 summation order, compounded over 5 fed-back steps.
"""

import jax
import numpy as np
import pytest

from nbody_gnn_hpc_torch.models import NBodyGNN, model_from_config
from nbody_gnn_hpc_torch.predict import Predictor, compare_with_hpc
from nbody_gnn_hpc_torch.sim import random_initial_conditions, shared_masses
from nbody_gnn_hpc_tpu.io.model_io import save_checkpoint
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.models.gnn import model_from_config as jax_from_config
from nbody_gnn_hpc_tpu.predict import Predictor as JaxPredictor

N, K, H, LAYERS, STEPS = 12, 4, 16, 2, 5
KW = dict(node_input_dim=7, hidden_dim=H, n_layers=LAYERS, output_dim=6,
          dropout=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    params = init_model(JaxGNN(**KW), jax.random.PRNGKey(0), N, N * K)
    params = jax.tree_util.tree_map(lambda p: p + 0.01, params)  # moves
    path = tmp_path_factory.mktemp("ckpt") / "model.pt"
    save_checkpoint(path, params=params,
                    norm_stats={"state_mean": np.full(6, 0.1, np.float32),
                                "state_std": np.full(6, 2.0, np.float32)},
                    model_config=KW)
    return str(path)


def _pair(ckpt, k=K):
    jax_pred = JaxPredictor(JaxGNN(**KW), model_path=ckpt, k_neighbors=k)
    port = Predictor(NBodyGNN(**KW), model_path=ckpt, device="cpu",
                     k_neighbors=k)
    return jax_pred, port


def _states(b=None, seed=0):
    rng = np.random.RandomState(seed)
    lead = () if b is None else (b,)
    return (rng.randn(*lead, N, 3).astype(np.float32),
            rng.randn(*lead, N, 3).astype(np.float32))


@pytest.mark.parametrize("trajectory", [True, False])
def test_rollout_matches_jax(small_ckpt, trajectory):
    jax_pred, port = _pair(small_ckpt)
    pos, vel = _states()
    masses = np.random.RandomState(1).uniform(1e10, 1e12, N)
    want = jax_pred.predict_rollout(pos, vel, masses, STEPS,
                                    trajectory=trajectory)
    got = port.predict_rollout(pos, vel, masses, STEPS,
                               trajectory=trajectory)
    shape = (STEPS + 1, N, 3) if trajectory else (N, 3)
    assert got["positions"].shape == shape
    assert got["positions"].dtype == np.float64
    final = got["positions"][-1] if trajectory else got["positions"]
    assert not np.allclose(final, pos)  # the model moves the state
    for key in ("positions", "velocities"):
        np.testing.assert_allclose(got[key], want[key], **TOL)


@pytest.mark.parametrize("per_system", [False, True])
def test_rollout_batch_matches_jax(small_ckpt, per_system):
    jax_pred, port = _pair(small_ckpt)
    pos, vel = _states(b=3, seed=2)
    rng = np.random.RandomState(3)
    masses = (rng.uniform(1e10, 1e12, (3, N)) if per_system
              else rng.uniform(1e10, 1e12, N)).astype(np.float32)
    want = jax_pred.predict_rollout_batch(pos, vel, masses, STEPS)
    got = port.predict_rollout_batch(pos, vel, masses, STEPS,
                                     out_dtype=np.float32)
    assert got["positions"].shape == (3, STEPS + 1, N, 3)
    assert got["positions"].dtype == np.float32
    for key in ("positions", "velocities"):
        np.testing.assert_allclose(got[key], want[key], **TOL)
    # per-system masses: system 1 alone gives the same rollout
    m1 = masses[1] if per_system else masses
    one = port.predict_rollout(pos[1], vel[1], m1, STEPS)
    np.testing.assert_allclose(got["positions"][1], one["positions"],
                               rtol=1e-5, atol=1e-5)


def test_predict_single_and_final_state_agree(small_ckpt):
    _, port = _pair(small_ckpt)
    pos, vel = _states(seed=4)
    masses = np.full(N, 1e11)
    p1, v1 = port.predict_single(pos, vel, masses)
    traj = port.predict_rollout(pos, vel, masses, 3)
    final = port.predict_rollout(pos, vel, masses, 3, trajectory=False)
    np.testing.assert_array_equal(p1, traj["positions"][1].astype(np.float32))
    np.testing.assert_array_equal(final["positions"], traj["positions"][-1])
    np.testing.assert_array_equal(final["velocities"],
                                  traj["velocities"][-1])


def test_fully_connected_when_k_is_none(small_ckpt):
    jax_pred, port = _pair(small_ckpt, k=None)
    pos, vel = _states(seed=5)
    masses = np.full(N, 1e11)
    want = jax_pred.predict_rollout(pos, vel, masses, 2)
    got = port.predict_rollout(pos, vel, masses, 2)
    np.testing.assert_allclose(got["positions"], want["positions"], **TOL)


def test_compare_with_hpc_contract(small_ckpt):
    _, port = _pair(small_ckpt)
    pos, vel = _states(seed=6)
    traj = {"positions": np.stack([pos] * 8), "velocities": np.stack([vel] * 8),
            "masses": np.full(N, 1e11)}
    out = compare_with_hpc(port, traj, start_step=2, n_prediction_steps=10)
    assert out["ai_positions"].shape == (6, N, 3)  # clipped to the data
    assert out["position_rmse"].shape == (6,)
    assert out["position_rmse"][0] == 0.0
    assert out["final_position_rmse"] == out["position_rmse"][-1]


def test_production_checkpoint_rollout_matches_jax():
    """models/best_rollout_model.pt, evaluation-protocol state (box 10,
    seed 9999, shared masses from seed 42), N=200, k=40, 5 steps.
    Tolerance: 1e-4 of each quantity's scale (six f32 LayerNorms per step,
    5 steps fed back)."""
    import json

    with open("models/config.json") as f:
        cfg = json.load(f)["model_config"]
    pos, vel, _ = random_initial_conditions(200, box_size=10.0, seed=9999)
    masses = shared_masses(200)
    jax_pred = JaxPredictor(jax_from_config(cfg, dtype_override="float32"),
                            model_path="models/best_rollout_model.pt",
                            k_neighbors=40)
    port = Predictor(model_from_config(cfg, dtype_override="float32"),
                     model_path="models/best_rollout_model.pt",
                     device="cpu", k_neighbors=40)
    want = jax_pred.predict_rollout_batch(pos[None], vel[None], masses, 5)
    got = port.predict_rollout_batch(pos[None], vel[None], masses, 5)
    for key in ("positions", "velocities"):
        assert np.isfinite(got[key]).all()
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-4 * np.abs(want[key]).max())
