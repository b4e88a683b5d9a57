"""The port's training path (nbody_gnn_hpc_torch/train, io/model_io writer)
against the JAX package's, on the CPU.

Small sizes (N=16, k=4, hidden 32, 2 layers, batch 4); inputs come from a
seeded numpy RNG and go through both frameworks as numpy arrays.  Weights
are made by the JAX ``init_model`` with a non-zero ``decoder_out`` (the
zero-initialised one would make every upstream gradient exactly 0) and
carried across with ``params_from_jax``.
"""

import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nbody_gnn_hpc_torch.config import TrainingConfig
from nbody_gnn_hpc_torch.io import (latest_checkpoint, params_from_jax,
                                    params_to_jax)
from nbody_gnn_hpc_torch.models import NBodyGNN
from nbody_gnn_hpc_torch.train import (GNNDataset, PhysicsInformedLoss,
                                       Trainer, cosine_warm_restarts,
                                       make_optimizer, make_step_schedule,
                                       make_train_step, mse_loss)
from nbody_gnn_hpc_tpu import config as jconfig
from nbody_gnn_hpc_tpu.io import model_io as jmodel_io
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.train import dataset as jdataset
from nbody_gnn_hpc_tpu.train import loss as jloss
from nbody_gnn_hpc_tpu.train import schedule as jschedule
from nbody_gnn_hpc_tpu.train import steps as jsteps

N, K, H, LAYERS, B = 16, 4, 32, 2, 4
KW = dict(node_input_dim=7, hidden_dim=H, n_layers=LAYERS, output_dim=6)


def _trajectories(n_traj=3, t=12, n=N, seed=0):
    rng = np.random.RandomState(seed)
    masses = rng.uniform(1e10, 1e11, n)
    return [dict(positions=(5 * rng.randn(t, n, 3)).astype(np.float32),
                 velocities=rng.randn(t, n, 3).astype(np.float32),
                 masses=masses) for _ in range(n_traj)]


def _jax_params(seed=0, dropout=0.0):
    jparams = init_model(JaxGNN(remat=False, dropout=dropout, **KW),
                         jax.random.PRNGKey(seed), N, N * K)
    # Non-zero decoder_out (and a nudge everywhere), so that gradients
    # reach every parameter.
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


# -- config, loss, schedule --------------------------------------------------


def test_config_matches_jax():
    assert TrainingConfig().to_dict() == jconfig.TrainingConfig().to_dict()
    d = {**TrainingConfig(batch_size=7).to_dict(), "unknown": 1}
    assert TrainingConfig.from_dict(d) == TrainingConfig(batch_size=7)
    assert TrainingConfig.get_device() in ("cuda", "cpu")


@pytest.mark.parametrize("with_masses", [True, False])
def test_physics_loss_matches_jax(with_masses):
    """Per-graph KE and momentum terms with mean-renormalised masses; f32
    reductions over 4x16 values, tolerance 1e-6 relative."""
    rng = np.random.RandomState(1)
    pred = rng.randn(B, N, 6).astype(np.float32)
    tgt = rng.randn(B, N, 6).astype(np.float32)
    m = rng.uniform(1e10, 1e12, N).astype(np.float32) if with_masses else None
    want_total, want = jloss.PhysicsInformedLoss()(
        jnp.asarray(pred), jnp.asarray(tgt),
        None if m is None else jnp.asarray(m))
    got_total, got = PhysicsInformedLoss()(
        torch.from_numpy(pred), torch.from_numpy(tgt),
        None if m is None else torch.from_numpy(m))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(got_total.item(), float(want_total), rtol=1e-6)
    np.testing.assert_allclose(
        mse_loss(torch.from_numpy(pred), torch.from_numpy(tgt)).item(),
        float(jloss.mse_loss(jnp.asarray(pred), jnp.asarray(tgt))),
        rtol=1e-6)


def test_schedule_matches_jax_at_restarts():
    epochs = [0, 1, 10, 19, 20, 21, 59, 60, 61, 139, 140, 141, 300]
    for e in epochs:
        assert cosine_warm_restarts(e, 5e-4) == pytest.approx(
            jschedule.cosine_warm_restarts(e, 5e-4), rel=1e-12)
    # restarts: the LR returns to base at epochs 20, 60, 140
    for e in (0, 20, 60, 140):
        assert cosine_warm_restarts(e, 5e-4) == pytest.approx(5e-4)
    assert cosine_warm_restarts(19, 5e-4) < cosine_warm_restarts(18, 5e-4)
    port, jax_sched = (make_step_schedule(5e-4, 7),
                       jschedule.make_step_schedule(5e-4, 7))
    for count in (0, 6, 7, 133, 139, 140, 141, 420):
        np.testing.assert_allclose(port(count), float(jax_sched(count)),
                                   rtol=1e-6)
    assert port(0) == 5e-4 and port(6) == 5e-4  # constant within an epoch


# -- dataset -----------------------------------------------------------------


def _assert_same_dataset(got, want):
    assert (got.n_samples, got.n_particles) == (want.n_samples,
                                                want.n_particles)
    np.testing.assert_array_equal(got.last_states, want.last_states)
    np.testing.assert_array_equal(got.targets, want.targets)
    np.testing.assert_array_equal(got.state_mean, want.state_mean)
    np.testing.assert_array_equal(got.state_std, want.state_std)
    np.testing.assert_array_equal(got.get_masses_tensor(),
                                  want.get_masses_tensor())
    ge, we = np.asarray(got.edge_index), np.asarray(want.edge_index)
    assert ge.shape == we.shape
    np.testing.assert_array_equal(ge[0], we[0])
    n = got.n_particles
    np.testing.assert_array_equal(np.sort(ge[1].reshape(n, -1), 1),
                                  np.sort(we[1].reshape(n, -1), 1))
    for i in (0, got.n_samples - 1):
        a, b = got[i], want[i]
        for key in ("x", "pos", "y"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("k", [K, None])
def test_from_trajectories_matches_jax(k):
    trajs = _trajectories()
    got = GNNDataset.from_trajectories(trajs, sequence_length=5, stride=2,
                                       k_neighbors=k)
    want = jdataset.GNNDataset.from_trajectories(
        trajs, sequence_length=5, stride=2, k_neighbors=k)
    _assert_same_dataset(got, want)
    val = GNNDataset.from_trajectories(
        trajs[:1], sequence_length=5, k_neighbors=k,
        external_norm_stats=got.get_normalization_stats())
    np.testing.assert_array_equal(val.state_mean, got.state_mean)


def _write_windowed(path, trajs, seq_len):
    """A tiny windowed dataset in the JAX package's HDF5 schema."""
    inputs, targets = [], []
    for tr in trajs:
        state = np.concatenate([tr["positions"], tr["velocities"]], -1)
        for s in range(state.shape[0] - seq_len):
            inputs.append(state[s:s + seq_len])
            targets.append(state[s + seq_len])
    with h5py.File(path, "w") as f:
        f.attrs["n_samples"] = len(inputs)
        f["inputs"] = np.stack(inputs)
        f["targets"] = np.stack(targets)
        f["masses"] = trajs[0]["masses"]


def test_hdf5_dataset_matches_jax(tmp_path):
    trajs = _trajectories(seed=2)
    path = tmp_path / "train_dataset.h5"
    _write_windowed(path, trajs, 5)
    got = GNNDataset(str(path), sequence_length=5, k_neighbors=K)
    want = jdataset.GNNDataset(str(path), sequence_length=5, k_neighbors=K)
    _assert_same_dataset(got, want)
    # the file path and the trajectory path give the same tensors
    _assert_same_dataset(
        GNNDataset.from_trajectories(trajs, sequence_length=5,
                                     k_neighbors=K), got)
    states, targets = got.device_arrays("cpu")
    assert states.dtype == torch.float32 and states.shape == (got.n_samples,
                                                              N, 6)
    np.testing.assert_array_equal(targets.numpy(), got.targets)


# -- the train step ----------------------------------------------------------


def _step_setup(seed=3):
    trajs = _trajectories(seed=seed)
    ds = GNNDataset.from_trajectories(trajs, sequence_length=5,
                                      k_neighbors=K)
    rng = np.random.RandomState(seed)
    batches = [rng.choice(ds.n_samples, B, replace=False) for _ in range(3)]
    mass_feat = (ds.masses / ds.masses.mean())[:, None].astype(np.float32)
    return ds, batches, mass_feat


def _port_step(jparams, ds, mass_feat, lr, wd, spe):
    model = NBodyGNN(dropout=0.0, **KW)
    model.load_state_dict(params_from_jax(jparams))
    opt = make_optimizer(model, lr, wd)
    step = make_train_step(
        model, opt, ds.edge_index, ds.state_mean, ds.state_std, mass_feat,
        noise_std=0.0, masses=torch.from_numpy(ds.get_masses_tensor()),
        schedule=make_step_schedule(lr, spe))
    return model, step


def _jax_step(ds, mass_feat, lr, wd, spe):
    model = JaxGNN(remat=False, dropout=0.0, **KW)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(jschedule.make_step_schedule(lr, spe),
                                 weight_decay=wd))
    step = jax.jit(jsteps.make_train_step(
        model, tx, ds.edge_index, ds.state_mean, ds.state_std, mass_feat,
        noise_std=0.0, masses=jnp.asarray(ds.get_masses_tensor())))
    return model, tx, step


# Loss and gradients: float32 through 2 interaction layers with 4
# LayerNorms, summation orders differ -> 1e-4 of each leaf's gradient
# scale.  Parameters after Adam: its first steps move each element by about
# lr * sign(g), so an element whose gradient is at float32 noise level can
# move either way; they are compared where |g| > 1e-3 of the leaf's scale,
# to 1e-6 absolute (a few ulps of O(1) weights after lr=5e-4 steps).
GRAD_REL, PARAM_ATOL, SIGNAL = 1e-4, 1e-6, 1e-3


def test_train_step_gradients_match_jax():
    ds, batches, mass_feat = _step_setup()
    jparams = _jax_params(seed=4)
    model, step = _port_step(jparams, ds, mass_feat, 5e-4, 1e-4, 1)
    states = torch.from_numpy(ds.last_states[batches[0]])
    targets = torch.from_numpy(ds.targets[batches[0]])
    loss, _ = step.compute_loss(states, targets)
    loss.backward()
    got = params_to_jax({n: p.grad for n, p in model.named_parameters()})

    jmodel, tx, _ = _jax_step(ds, mass_feat, 5e-4, 1e-4, 1)
    raw = jsteps.make_train_step(
        jmodel, tx, ds.edge_index, ds.state_mean, ds.state_std, mass_feat,
        noise_std=0.0, masses=jnp.asarray(ds.get_masses_tensor()))
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: raw.compute_loss(p, jnp.asarray(states.numpy()),
                                   jnp.asarray(targets.numpy()),
                                   jax.random.PRNGKey(0))[0]))(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_leaves = dict(_leaves(want))
    for path, g in _leaves(got):
        w = want_leaves[path]
        assert np.abs(w).max() > 0, path  # every leaf gets a gradient
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(
            w).max(), err_msg=path)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(n_steps):
    """n AdamW + clip steps from the same parameters, dropout and noise
    off, one step per epoch (the LR follows the schedule's count)."""
    ds, batches, mass_feat = _step_setup(seed=5)
    jparams = _jax_params(seed=6)
    lr, wd = 5e-4, 1e-4
    model, step = _port_step(jparams, ds, mass_feat, lr, wd, 1)
    _, tx, jstep = _jax_step(ds, mass_feat, lr, wd, 1)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    opt_state = tx.init(jp)
    for i in range(n_steps):
        s, t = ds.last_states[batches[i]], ds.targets[batches[i]]
        loss = step(torch.from_numpy(s), torch.from_numpy(t))
        jp, opt_state, jloss_v = jstep(jp, opt_state, jnp.asarray(s),
                                       jnp.asarray(t), jax.random.PRNGKey(i))
        np.testing.assert_allclose(loss.item(), float(jloss_v), rtol=1e-4,
                                   err_msg=f"loss of step {i}")
    assert step.count == n_steps
    # The first step's gradient marks which elements carry signal.
    g_model, g_step = _port_step(jparams, ds, mass_feat, lr, wd, 1)
    g_loss, _ = g_step.compute_loss(
        torch.from_numpy(ds.last_states[batches[0]]),
        torch.from_numpy(ds.targets[batches[0]]))
    g_loss.backward()
    signal = dict(_leaves(params_to_jax(
        {n: p.grad for n, p in g_model.named_parameters()})))
    got = dict(_leaves(params_to_jax(model.state_dict())))
    compared = 0
    for path, want in _leaves(jax.tree_util.tree_map(np.asarray, jp)):
        g = np.abs(signal[path])
        mask = g > SIGNAL * g.max()
        np.testing.assert_allclose(got[path][mask], want[mask], rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)
        compared += int(mask.sum())
    assert compared > 0.5 * sum(v.size for v in got.values())


def test_train_step_refuses_irregular_edges():
    ds, _, mass_feat = _step_setup()
    model = NBodyGNN(dropout=0.0, **KW)
    with pytest.raises(ValueError, match="row-regular"):
        make_train_step(model, make_optimizer(model, 1e-3, 0.0),
                        np.flip(ds.edge_index, 0).copy(), ds.state_mean,
                        ds.state_std, mass_feat)


# -- checkpoints and the trainer ---------------------------------------------


def test_params_to_jax_inverts_params_from_jax():
    jparams = _jax_params(seed=7)
    back = dict(_leaves(params_to_jax(params_from_jax(jparams))))
    for path, val in _leaves(jparams):
        np.testing.assert_array_equal(back.pop(path), val)
    assert not back


@pytest.fixture
def trained(tmp_path):
    trajs = _trajectories(seed=8)
    train = GNNDataset.from_trajectories(trajs, sequence_length=5,
                                         k_neighbors=K)
    val = GNNDataset.from_trajectories(
        trajs[:1], sequence_length=4, k_neighbors=K,
        external_norm_stats=train.get_normalization_stats())
    trainer = Trainer(NBodyGNN(dropout=0.1, **KW), train, val,
                      model_dir=str(tmp_path), device="cpu", batch_size=B,
                      seed=1)
    history = trainer.train(n_epochs=2, save_every=2, verbose=False)
    return trainer, history, tmp_path


def test_trainer_run_writes_jax_history_and_checkpoints(trained):
    trainer, history, model_dir = trained
    assert sorted(os.listdir(model_dir)) == [
        "best_model.pt", "checkpoint_epoch_2.pt", "final_model.pt",
        "training_history.json"]
    keys = {"train_loss", "val_loss", "learning_rate", "energy_loss",
            "momentum_loss", "epoch_time_s"}
    assert set(history) == keys
    assert all(len(v) == 2 for v in history.values())
    assert all(np.isfinite(history["train_loss"] + history["val_loss"]))
    on_disk = json.loads((model_dir / "training_history.json").read_text())
    assert on_disk["completed"] and not on_disk["early_stopped"]
    assert history["learning_rate"] == [cosine_warm_restarts(e, 5e-4)
                                        for e in (0, 1)]
    assert trainer._step.count == 2 * trainer.steps_per_epoch
    assert latest_checkpoint(model_dir) == "final_model.pt"
    ckpt = jmodel_io.load_checkpoint(model_dir / "final_model.pt")
    assert ckpt["scheduler_state_dict"] == {"epoch": 2}
    assert set(ckpt) >= {"model_state_dict", "optimizer_state_dict",
                         "best_val_loss", "history", "norm_stats",
                         "model_config"}


def test_port_checkpoint_loads_in_jax(trained):
    """best_model.pt written by the port -> the JAX package's loader and
    model.apply give the port's output (float32 through 2 layers)."""
    trainer, _, model_dir = trained
    ckpt = jmodel_io.load_checkpoint(model_dir / "best_model.pt")
    cfg = ckpt["model_config"]
    jmodel = JaxGNN(remat=False, **cfg)
    x = np.random.RandomState(9).randn(N, 7).astype(np.float32)
    ei = trainer.edge_index.numpy()
    want = jmodel.apply({"params": jax.tree_util.tree_map(
        jnp.asarray, ckpt["model_state_dict"])}, jnp.asarray(x),
        jnp.asarray(ei), deterministic=True)
    port = NBodyGNN(**cfg)
    port.load_state_dict(params_from_jax(ckpt["model_state_dict"]))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(ei))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(ckpt["norm_stats"]["state_mean"],
                                  trainer.norm_stats["state_mean"])


def test_trainer_resumes_where_it_stopped(trained):
    trainer, _, model_dir = trained
    again = Trainer(NBodyGNN(dropout=0.1, **KW), _dataset_like(trainer),
                    model_dir=str(model_dir), device="cpu", batch_size=B,
                    seed=2)
    again.load_model("final_model.pt")
    assert again.current_epoch == 2
    assert again._step.count == trainer._step.count
    for (name, p), q in zip(again.model.named_parameters(),
                            trainer.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
    state = again.optimizer.state_dict()["state"]
    torch.testing.assert_close(state[0]["exp_avg"],
                               trainer.optimizer.state_dict()["state"][0][
                                   "exp_avg"], rtol=0, atol=0)


def _dataset_like(trainer):
    """A dataset object holding the trainer's own tensors."""
    ds = GNNDataset.__new__(GNNDataset)
    ds.last_states = trainer.train_states.numpy()
    ds.targets = trainer.train_targets.numpy()
    ds.masses = trainer.masses.numpy()
    ds.edge_index = trainer.edge_index.numpy()
    ds.state_mean = trainer.norm_stats["state_mean"]
    ds.state_std = trainer.norm_stats["state_std"]
    return ds


def test_train_model_cli_on_cpu(tmp_path):
    from nbody_gnn_hpc_torch.train_model import main

    trajs = _trajectories(seed=10)
    data = tmp_path / "data"
    data.mkdir()
    _write_windowed(data / "train_dataset.h5", trajs, 5)
    _write_windowed(data / "val_dataset.h5", trajs[:1], 5)
    out = tmp_path / "models"
    flags = ["--device", "cpu", "--data-dir", str(data), "--model-dir",
             str(out), "--hidden-dim", str(H), "--n-layers", str(LAYERS),
             "--k-neighbors", str(K), "-b", str(B)]
    assert main(flags + ["--epochs", "1"]) == 0
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["model_config"]["hidden_dim"] == H
    assert cfg["training_config"]["k_neighbors"] == K
    assert main(flags + ["--epochs", "2", "--resume", "auto"]) == 0
    hist = json.loads((out / "training_history.json").read_text())
    assert len(hist["train_loss"]) == 2
