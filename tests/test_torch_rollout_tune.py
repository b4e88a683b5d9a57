"""The port's rollout fine-tune (nbody_gnn_hpc_torch/train/rollout_tune.py
and the finetune_rollout command) against the JAX package's, on the CPU.

Small sizes (N=12, k=4, hidden 16, 2 layers); inputs come from a seeded
numpy RNG and go through both frameworks as numpy arrays.  Weights are made
by the JAX ``init_model`` with a non-zero ``decoder_out`` (the
zero-initialised one blocks every gradient but the last layer's) and carried
across with ``params_from_jax``.  The JAX model runs the edge stream through
its Pallas kernel in interpret mode (``edge_impl="fused"``) opposite the
port's ``"fused"``, and through ``"xla"`` opposite ``"fused_full"``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch import finetune_rollout as cli
from nbody_gnn_hpc_torch.io import (CheckpointManager, params_from_jax,
                                    params_to_jax, save_checkpoint)
from nbody_gnn_hpc_torch.models import NBodyGNN
from nbody_gnn_hpc_torch.ops.knn import knn_edge_index
from nbody_gnn_hpc_torch.train import (finetune_rollout,
                                       load_trajectory_tensor,
                                       make_unroll_loss)
from nbody_gnn_hpc_tpu.io import load_checkpoint as jax_load_checkpoint
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.train import rollout_tune as jrt

N, K, H, LAYERS = 12, 4, 16, 2
KW = dict(node_input_dim=7, hidden_dim=H, n_layers=LAYERS, output_dim=6)
# Loss: float32 through 3 chained steps of 2 layers -> rtol 1e-5.
# Gradients: summation orders differ -> 1e-4 of each leaf's scale, as the
# one-step training gradients (tests/test_torch_train.py).
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
JAX_IMPL = {"fused": "fused", "fused_full": "xla"}


def _jax_params(seed=0):
    jparams = init_model(JaxGNN(remat=False, dropout=0.0, edge_impl="xla",
                                **KW), jax.random.PRNGKey(seed), N, N * K)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * np.sign(
            np.arange(p.size).reshape(p.shape) % 3 - 1).astype(np.float32),
        jparams)


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def _problem(b=2, horizon=3, seed=0):
    """(B, horizon+1, N, 6) raw windows, norm stats and the mass feature."""
    rng = np.random.RandomState(seed)
    seq = np.concatenate([5 * rng.randn(b, horizon + 1, N, 3),
                          rng.randn(b, horizon + 1, N, 3)], -1)
    norm = {"state_mean": (0.1 * rng.randn(6)).astype(np.float32),
            "state_std": (1 + rng.rand(6)).astype(np.float32)}
    masses = rng.uniform(1e10, 1e11, N).astype(np.float32)
    mass_feat = (masses / masses.mean()).reshape(-1, 1).astype(np.float32)
    return seq.astype(np.float32), norm, masses, mass_feat


def _port_model(jparams, edge_impl="fused"):
    model = NBodyGNN(dropout=0.0, edge_impl=edge_impl, **KW)
    model.load_state_dict(params_from_jax(jparams))
    return model


def _port_grads(model, loss_fn, seq):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(torch.from_numpy(seq))
    loss.backward()
    return loss.item(), dict(_leaves(params_to_jax(
        {n: p.grad for n, p in model.named_parameters()})))


def _jax_loss_and_grads(jparams, edge_impl, norm, mass_feat, k, horizon,
                        seq):
    loss_fn = jrt.make_unroll_loss(
        JaxGNN(remat=False, dropout=0.0, edge_impl=edge_impl, **KW), norm,
        jnp.asarray(mass_feat), k, N, horizon)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(seq))
    return float(loss), dict(_leaves(grads))


def _max_rel(got, want):
    return max(np.abs(got[p] - w).max() / np.abs(w).max()
               for p, w in want.items())


@pytest.mark.parametrize("edge_impl", ["fused", "fused_full"])
@pytest.mark.parametrize("k", [K, None])
def test_unroll_loss_and_gradients_match_jax(edge_impl, k):
    """K=3, B=2; ``k=None`` is the fully connected edge set."""
    seq, norm, _, mass_feat = _problem()
    jparams = _jax_params()
    model = _port_model(jparams, edge_impl)
    loss, got = _port_grads(
        model, make_unroll_loss(model, norm, mass_feat, k, N, 3), seq)
    want_loss, want = _jax_loss_and_grads(jparams, JAX_IMPL[edge_impl], norm,
                                          mass_feat, k, 3, seq)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert np.abs(w).max() > 0, path  # every leaf gets a gradient
        err = np.abs(got[path] - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


def _detached_loss(model, norm, mass_feat, horizon):
    """The unroll loss with every step's input cut from the graph: the sum
    of one-step losses from each predicted state."""
    one_step = make_unroll_loss(model, norm, mass_feat, K, N, 1)
    mean = torch.as_tensor(norm["state_mean"])
    std = torch.as_tensor(norm["state_std"])
    feat = torch.from_numpy(mass_feat)

    def loss(seq):
        s_raw, total = seq[:, 0], 0.0
        for t in range(horizon):
            total = total + one_step(torch.stack([s_raw, seq[:, t + 1]], 1))
            with torch.no_grad():
                s_norm = (s_raw - mean) / std
                x = torch.cat([s_norm, feat.expand(*s_norm.shape[:-1], 1)],
                              -1)
                edges = knn_edge_index(s_norm[..., :3], K)
                s_raw = model(x, edges, s_norm[..., :3]) * std + mean
        return total / horizon

    return loss


@pytest.mark.parametrize("edge_impl", ["fused", "fused_full"])
def test_gradient_through_the_fed_back_state_carries_weight(edge_impl):
    """The chained gradient is not the sum of one-step gradients from the
    same states: a backward that dropped the gradient of the edge features
    (kernel 2's ``d_edge_attr``) or of the fed-back state would fail the
    JAX comparison above by more than its tolerance."""
    seq, norm, _, mass_feat = _problem()
    model = _port_model(_jax_params(), edge_impl)
    chained_loss, chained = _port_grads(
        model, make_unroll_loss(model, norm, mass_feat, K, N, 3), seq)
    cut_loss, cut = _port_grads(
        model, _detached_loss(model, norm, mass_feat, 3), seq)
    np.testing.assert_allclose(cut_loss, chained_loss, rtol=LOSS_RTOL)
    assert _max_rel(cut, chained) > 100 * GRAD_REL


def test_unroll_loss_zero_for_static_truth():
    """The zero-initialised model predicts the identity; on a constant
    truth the unrolled loss is exactly 0."""
    rng = np.random.RandomState(0)
    model = NBodyGNN(hidden_dim=8, n_layers=1, dropout=0.0)
    norm = {"state_mean": np.zeros(6, np.float32),
            "state_std": np.ones(6, np.float32)}
    masses = rng.rand(10).astype(np.float32)
    loss_fn = make_unroll_loss(model, norm, (masses / masses.mean())[:, None],
                               4, 10, 3)
    state = rng.randn(10, 6).astype(np.float32)
    seq = np.repeat(state[None, None], 4, axis=1)  # (1, 4, 10, 6)
    assert loss_fn(torch.from_numpy(seq)).item() == 0.0


def _trajectories(n_sims=5, n_saves=12, seed=1):
    """Constant-velocity drift (learnable beyond the identity), raw units,
    and the norm stats of the set."""
    rng = np.random.RandomState(seed)
    pos0 = 3 * rng.randn(n_sims, 1, N, 3)
    vel = 0.2 * rng.randn(n_sims, 1, N, 3)
    t = np.arange(n_saves)[None, :, None, None]
    trajs = np.concatenate([pos0 + vel * t, np.broadcast_to(
        vel, (n_sims, n_saves, N, 3))], axis=-1).astype(np.float32)
    norm = {"state_mean": trajs.reshape(-1, 6).mean(0),
            "state_std": trajs.reshape(-1, 6).std(0) + 1e-6}
    masses = rng.uniform(1e10, 1e11, N).astype(np.float32)
    return trajs, norm, masses


def test_finetune_draws_the_jax_windows_and_history():
    """10 steps, ``log_every=5``: the same fixed validation windows and
    step windows from ``RandomState(seed)`` give the JAX history."""
    trajs, norm, masses = _trajectories()
    jparams = _jax_params(seed=2)
    kw = dict(k_neighbors=K, horizon=3, batch_size=2, learning_rate=1e-3,
              n_steps=10, seed=5, log_every=5)
    _, want = jrt.finetune_rollout(
        JaxGNN(remat=False, dropout=0.0, edge_impl="xla", **KW),
        jax.tree_util.tree_map(jnp.asarray, jparams), trajs, norm, masses,
        **kw)
    _, got = finetune_rollout(_port_model(jparams), trajs, norm, masses,
                              **kw)
    assert len(got["val_loss"]) == len(want["val_loss"]) == 3
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    assert got["val_loss"][-1] < got["val_loss"][0]


def test_finetune_returns_a_copy_of_the_best_and_beats():
    trajs, norm, masses = _trajectories(seed=3)
    model = _port_model(_jax_params(seed=3))
    beats = []
    kw = dict(k_neighbors=K, horizon=2, batch_size=2, seed=7)
    best, history = finetune_rollout(
        model, trajs, norm, masses, learning_rate=1e-3, n_steps=7,
        log_every=3, progress_cb=lambda: beats.append(1), **kw)
    # the initial readback, then every log_every steps and the last step
    assert len(beats) == 1 + 7 // 3 + 1 == len(history["val_loss"])
    # The model holds the best parameters: a new call's initial validation
    # loss (the same windows, drawn from the same seed) is the best one.
    _, again = finetune_rollout(model, trajs, norm, masses,
                                learning_rate=0.0, n_steps=1, log_every=1,
                                **kw)
    np.testing.assert_allclose(again["val_loss"][0],
                               min(history["val_loss"]), rtol=1e-6)
    state = model.state_dict()
    assert best.keys() == state.keys()
    for name, t in best.items():
        assert torch.equal(t, state[name])
        assert t.data_ptr() != state[name].data_ptr()  # a copy
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    assert all(not torch.equal(t, state[name]) for name, t in best.items())


def test_beats_count_with_a_divisible_step_count():
    trajs, norm, masses = _trajectories(seed=4)
    beats = []
    finetune_rollout(_port_model(_jax_params(seed=4)), trajs, norm, masses,
                     k_neighbors=None, horizon=2, batch_size=2, n_steps=6,
                     log_every=3, progress_cb=lambda: beats.append(1))
    assert len(beats) == 1 + 6 // 3


def test_base_checkpoint_reads_without_optax(tmp_path):
    """``models/best_model.pt``, the fine-tune's base, pickles optax state
    classes in its optimizer state; the machine with the card has no optax.
    The parameters and statistics read there equal those read here."""
    repo = Path(__file__).resolve().parent.parent
    code = ("import sys; sys.modules['optax'] = None\n"
            "import numpy as np\n"
            "from nbody_gnn_hpc_torch.io import load_checkpoint\n"
            "c = load_checkpoint('models/best_model.pt')\n"
            "np.savez(sys.argv[1], mean=c['norm_stats']['state_mean'], "
            "w=c['model_state_dict']['layer_0']['edge_proj_target']"
            "['kernel'], count=c['optimizer_state_dict'][1][0][0])\n")
    out = tmp_path / "read.npz"
    proc = subprocess.run([sys.executable, "-c", code, str(out)], cwd=repo,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(repo)})
    assert proc.returncode == 0, proc.stderr
    got = np.load(out)
    want = jax_load_checkpoint(repo / "models" / "best_model.pt")
    np.testing.assert_array_equal(got["mean"],
                                  want["norm_stats"]["state_mean"])
    np.testing.assert_array_equal(
        got["w"], want["model_state_dict"]["layer_0"]["edge_proj_target"]
        ["kernel"])
    assert int(got["count"]) == int(want["optimizer_state_dict"][1][0].count)


# -- the command -------------------------------------------------------------


@pytest.mark.parametrize("spec,msg", [("8:x", "expected 'K:steps"),
                                      ("8", "expected 'K:steps"),
                                      ("0:5", ">= 1"), ("8:100,16:0", ">= 1")])
def test_parse_curriculum_errors(spec, msg):
    with pytest.raises(ValueError, match=msg):
        cli.parse_curriculum(spec)


def test_parse_curriculum():
    assert cli.parse_curriculum("8:1500,16:900") == [(8, 1500), (16, 900)]


def _write_run(tmp_path, n_sims=10, n_saves=10):
    """Trajectory files, a small model's checkpoint and its config."""
    trajs, norm, masses = _trajectories(n_sims=n_sims, n_saves=n_saves,
                                        seed=6)
    mgr = CheckpointManager(str(tmp_path / "data" / "checkpoints"))
    for i, tr in enumerate(trajs):
        mgr.save_trajectory([dict(positions=s[:, :3], velocities=s[:, 3:],
                                  accelerations=np.zeros((N, 3)),
                                  masses=masses) for s in tr],
                            f"sim_{i:04d}")
    model_config = dict(KW, dropout=0.0, edge_impl="auto")
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_config": model_config,
                   "training_config": {"k_neighbors": K}}, f)
    save_checkpoint(tmp_path / "best_model.pt", params=_jax_params(seed=6),
                    norm_stats=norm, model_config=model_config)
    return trajs, masses


def _args(tmp_path, *extra):
    return ["--device", "cpu", "-m", str(tmp_path / "best_model.pt"),
            "-c", str(tmp_path / "config.json"),
            "-d", str(tmp_path / "data"),
            "-o", str(tmp_path / "best_rollout_model.pt"), "-b", "2",
            *extra]


def test_cli_reads_the_train_split(tmp_path, monkeypatch):
    """The first 80 % of the sorted names, then ``--max-sims``; masses
    from the first file."""
    trajs, masses = _write_run(tmp_path)
    seen = {}

    def spy(model, trajectories, norm_stats, masses_, rungs, **kw):
        seen.update(trajectories=trajectories, masses=masses_, rungs=rungs)

    monkeypatch.setattr(cli, "finetune_curriculum", spy)
    assert cli.main(_args(tmp_path, "--steps", "3")) == 0
    np.testing.assert_allclose(seen["trajectories"], trajs[:8], rtol=1e-6)
    np.testing.assert_array_equal(seen["masses"], masses)
    assert seen["rungs"] == [(8, 3)]
    assert cli.main(_args(tmp_path, "--max-sims", "3")) == 0
    assert seen["trajectories"].shape[0] == 3
    np.testing.assert_allclose(
        load_trajectory_tensor(tmp_path / "data" / "checkpoints",
                               ["sim_0002"]), trajs[2:3], rtol=1e-6)


def test_cli_two_rungs_saved_for_the_jax_package(tmp_path):
    _write_run(tmp_path)
    assert cli.main(_args(tmp_path, "--curriculum", "2:3,3:2")) == 0
    ckpt = jax_load_checkpoint(tmp_path / "best_rollout_model.pt")
    ft = ckpt["finetune"]
    assert [tuple(r) for r in ft["curriculum"]] == [(2, 3), (3, 2)]
    assert ft["base"] == str(tmp_path / "best_model.pt")
    assert [(r["horizon"], r["steps"]) for r in ft["rungs"]] == [(2, 3),
                                                                 (3, 2)]
    assert all(len(r["history"]["val_loss"]) == 2 for r in ft["rungs"])
    assert ckpt["history"] == ft["rungs"][-1]["history"]
    assert ckpt["model_config"]["hidden_dim"] == H
    np.testing.assert_array_equal(ckpt["norm_stats"]["state_mean"],
                                  _trajectories(10, 10, 6)[1]["state_mean"])
    # The JAX model runs the saved parameters.
    out = JaxGNN(remat=False, dropout=0.0, edge_impl="xla", **KW).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray,
                                          ckpt["model_state_dict"])},
        jnp.zeros((N, 7)), jnp.asarray(np.stack(
            [np.repeat(np.arange(N), N - 1),
             np.array([j for i in range(N) for j in range(N) if j != i])])),
        deterministic=True)
    assert out.shape == (N, 6) and bool(jnp.isfinite(out).all())


def test_cli_without_trajectories_fails(tmp_path):
    _write_run(tmp_path, n_sims=1)  # 80 % of one file is none
    assert cli.main(_args(tmp_path)) == 1
