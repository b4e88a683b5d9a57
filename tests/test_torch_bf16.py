"""bf16 training, the production recipe's precision (a bfloat16 model: bf16
products, float32 parameters), in the port against the JAX package's, on
the CPU.

The JAX kernels run as the JAX package's tests run them, in interpret mode;
their bf16 form (``cd = bfloat16``, the form its accelerator runs for a
bf16 model) is selected by calling the JAX wrappers with ``interpret=False``
while ``pl.pallas_call`` is made to interpret: ``interpret=True`` alone
selects the float32 form.  Nothing in the JAX package changes.  Small sizes
(hidden 32, 2 layers, N=32, k=8); inputs from seeded numpy RNGs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nbody_gnn_hpc_tpu.ops.fused_edge as jfused
from nbody_gnn_hpc_torch.io import (load_checkpoint, load_into,
                                    params_from_jax)
from nbody_gnn_hpc_torch.models import NBodyGNN, model_from_config
from nbody_gnn_hpc_torch.ops import (fused_edge_backward,
                                     fused_edge_backward_reference,
                                     fused_edge_layer,
                                     fused_edge_layer_reference, target_csr)
from nbody_gnn_hpc_torch.train import GNNDataset, Trainer
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.models.gnn import target_adjacency
from nbody_gnn_hpc_tpu.ops import knn as jknn
from nbody_gnn_hpc_tpu.ops.fused_edge_batched import \
    fused_edge_layer_batched as jfused_batched
from tests.test_torch_train import _trajectories, _write_windowed

N, K, H, LAYERS = 32, 8, 32, 2
KW = dict(node_input_dim=7, hidden_dim=H, n_layers=LAYERS, output_dim=6,
          dropout=0.1)
CONFIG = "models/config.json"  # says "dtype": "bfloat16"
CKPT = "models/best_rollout_model.pt"
# The port's bf16 plain versions against the JAX bf16 kernels: the same
# roundings at the same places, so what is left is float32 summation order
# (LayerNorm means, the target sums), 1e-5 of each tensor's scale.  The
# float32 stream, on the same bf16 projections, is ~1e-3 of scale away
# (each activation rounded to 8 bits): the port must be nearer the bf16
# kernel than the float32 one by at least NEARER.
BF16_REL = 1e-5
NEARER = 2.0
GRAD_NAMES = ("d_t_proj", "d_s_proj", "d_edge_attr", "d_w_e", "d_gamma",
              "d_beta")


@pytest.fixture
def tpu_bf16_stream(monkeypatch):
    """The JAX wrappers' bf16 form on the CPU: ``interpret=False`` selects
    ``cd = bfloat16`` and the bf16 one-hot matrix (as on the accelerator),
    and every ``pallas_call`` runs in interpret mode."""
    call = pl.pallas_call

    def interpreted(*args, **kwargs):
        return call(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    layer = jfused.fused_edge_layer
    monkeypatch.setattr(jfused, "fused_edge_layer", lambda *a, **kw: layer(
        *a, **{**kw, "interpret": False}))


def _inputs(seed, batch=None):
    rng = np.random.RandomState(seed)
    lead = () if batch is None else (batch,)
    return dict(
        pos=rng.randn(*lead, N, 3).astype(np.float32),
        tp=rng.randn(*lead, N, H).astype(np.float32),
        sp=rng.randn(*lead, N, H).astype(np.float32),
        ea=rng.randn(*lead, N * K, 5).astype(np.float32),
        we=(rng.randn(5, H) * 0.3).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.randn(H)).astype(np.float32),
        beta=(0.1 * rng.randn(H)).astype(np.float32),
        g_out=rng.randn(*lead, N, H).astype(np.float32))


def _jax_stream(d, fn, bf16, interpret):
    """(out, six cotangents) of the JAX layer ``fn`` on ``d``: bf16
    projections, or their float32 widening."""
    pos = d["pos"] if d["pos"].ndim == 2 else d["pos"][0]
    ei = jknn.knn_edge_index(jnp.asarray(pos), K)
    adj, _ = target_adjacency(ei, N, jnp.float32)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    args = [jnp.asarray(d[key]).astype(jnp.bfloat16).astype(dt)
            for key in ("tp", "sp")]
    args += [jnp.asarray(d[key]) for key in ("ea", "we", "gamma", "beta")]
    out, vjp = jax.vjp(lambda *a: fn(
        *a, adj.T, jnp.zeros((1, 1), jnp.int32), k=K, interpret=interpret,
        deterministic=True), *args)
    return np.asarray(out), vjp(jnp.asarray(d["g_out"])), np.asarray(ei)


def _port_args(d, ei, batch=None):
    t = {key: torch.from_numpy(d[key]) for key in d}
    eit = torch.tensor(ei).long()
    if batch:
        eit = eit.expand(batch, -1, -1)
    return (t["tp"].bfloat16(), t["sp"].bfloat16(), t["ea"], t["we"],
            t["gamma"], t["beta"], target_csr(eit, N))


def _rel(got, want) -> float:
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _assert_bf16_form(got, want_bf16, want_f32, name):
    """Within BF16_REL of the bf16 kernel's scale, and NEARER times nearer
    it (in the mean) than the float32 stream's result."""
    got = np.asarray(got, np.float32)
    assert _rel(got, want_bf16) <= BF16_REL, name
    near = np.abs(got - np.asarray(want_bf16, np.float32)).mean()
    far = np.abs(got - np.asarray(want_f32, np.float32)).mean()
    assert far >= NEARER * near, (name, near, far)


@pytest.mark.parametrize("batch", [None, 3])
def test_bf16_stream_matches_jax_kernels(tpu_bf16_stream, batch):
    """Kernels 1 and 2 (and their batch-folded twins 8 and 9 at B=3) in the
    bf16 form: the plain versions against the JAX ``_fwd_kernel`` /
    ``_bwd_kernel`` with ``cd = bfloat16``, forward and all six cotangents
    (d_t_proj and d_s_proj bfloat16, the rest float32)."""
    d = _inputs(seed=31 if batch is None else 32, batch=batch)
    fn = jfused.fused_edge_layer if batch is None else jfused_batched
    want16, jgrads16, ei = _jax_stream(d, fn, bf16=True, interpret=False)
    want32, jgrads32, _ = _jax_stream(d, fn, bf16=False, interpret=True)
    args = _port_args(d, ei, batch)
    got = fused_edge_layer_reference(*args)
    assert got.dtype == torch.float32
    _assert_bf16_form(got.numpy(), want16, want32, "out")
    grads = fused_edge_backward_reference(*args,
                                          torch.from_numpy(d["g_out"]))
    for name, g, w16, w32 in zip(GRAD_NAMES, grads, jgrads16, jgrads32):
        bf16 = name in ("d_t_proj", "d_s_proj")
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32), name
        assert w16.dtype == (jnp.bfloat16 if bf16 else jnp.float32), name
        assert g.shape == w16.shape, name
        _assert_bf16_form(g.float().numpy(), w16, w32, name)


def test_bf16_wrapper_on_cpu_is_the_plain_version():
    """The wrapper on CPU tensors runs the plain bf16 version (no kernel
    launch counted in either form), and gives d_t_proj / d_s_proj back in
    bf16 through autograd."""
    d = _inputs(seed=33)
    ei = np.asarray(jknn.knn_edge_index(jnp.asarray(d["pos"]), K))
    args = list(_port_args(d, ei))
    args[0].requires_grad_(True)
    args[1].requires_grad_(True)
    counts = (fused_edge_layer.launches, fused_edge_layer.bf16_launches,
              fused_edge_backward.bf16_launches)
    out = fused_edge_layer(*args)
    out.backward(torch.from_numpy(d["g_out"]))
    assert (fused_edge_layer.launches, fused_edge_layer.bf16_launches,
            fused_edge_backward.bf16_launches) == counts
    torch.testing.assert_close(out, fused_edge_layer_reference(*args),
                               rtol=0, atol=0)
    want = fused_edge_backward_reference(*args, torch.from_numpy(d["g_out"]))
    for got, w in zip((args[0].grad, args[1].grad), want[:2]):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_mixed_projection_dtypes_are_refused():
    d = _inputs(seed=34)
    ei = np.asarray(jknn.knn_edge_index(jnp.asarray(d["pos"]), K))
    tp, sp, *rest = _port_args(d, ei)
    with pytest.raises(TypeError, match="one dtype"):
        fused_edge_layer(tp, sp.float(), *rest)
    with pytest.raises(TypeError, match="one dtype"):
        fused_edge_backward_reference(tp.float(), sp, *rest,
                                      torch.from_numpy(d["g_out"]))


def test_bf16_stream_rounds_each_term_after_dropout():
    """With one edge into each target, the bf16 forward is the float32
    forward rounded to bf16, element for element, also in training: each
    activation is rounded after dropout and its 1/(1-p), and both dtypes
    draw the same Philox mask (dropped channels are 0 in both, and a third
    of nothing else)."""
    rng = np.random.RandomState(35)
    n = 64
    row = torch.from_numpy(rng.permutation(n)).long()
    ei = torch.stack([row, torch.arange(n)])  # target t from one source
    tp = torch.from_numpy(rng.randn(n, H).astype(np.float32)).bfloat16()
    sp = torch.from_numpy(rng.randn(n, H).astype(np.float32)).bfloat16()
    ea = torch.from_numpy(rng.randn(n, 5).astype(np.float32))
    we = torch.from_numpy((rng.randn(5, H) * 0.3).astype(np.float32))
    gamma, beta = torch.ones(H), torch.zeros(H)
    csr = target_csr(ei, n)
    seed = torch.tensor([7], dtype=torch.int32)
    for sd, p in ((None, 0.0), (seed, 0.1)):
        got = fused_edge_layer_reference(tp, sp, ea, we, gamma, beta, csr,
                                         sd, p)
        f32 = fused_edge_layer_reference(tp.float(), sp.float(), ea, we,
                                         gamma, beta, csr, sd, p)
        assert torch.equal(got, f32.bfloat16().float())
        if sd is not None:
            dropped = f32 == 0
            assert 0.05 < dropped.float().mean() < 0.15
            assert torch.equal(got == 0, dropped)


def _jax_model_params(seed=0):
    jparams = init_model(JaxGNN(remat=False, **KW),
                         jax.random.PRNGKey(seed), N, N * K)
    # Non-zero decoder_out (a nudge everywhere) so the whole network shows.
    return jax.tree_util.tree_map(
        lambda p: p + 0.01 * np.sign(np.arange(p.size).reshape(p.shape) % 3
                                     - 1), jparams)


def test_bf16_model_matches_jax_bf16_model(tpu_bf16_stream):
    """NBodyGNN(dtype=torch.bfloat16) against the JAX NBodyGNN(dtype=
    jnp.bfloat16, edge_impl="fused") on the same weights: forward and the
    gradients of every parameter, for a fixed weighting of the outputs.

    The two round at the same places, but float32 summation order can move
    a value across a bf16 rounding boundary now and then, and that step
    (2^-8 of the value) then travels through the network; and XLA's CPU
    backend sums the gradient of a bf16 Dense's bias in bf16, where the
    port sums in float32 and rounds once.  So no element-wise bound tells
    the forms apart; what does: the output and the whole gradient (the
    total absolute difference over every parameter) are NEARER times
    nearer the JAX bf16 model than the JAX float32 one.  Bounds beside
    that: the output within 1e-4 of its scale, each gradient within 2^-4
    of its scale (a few bf16 steps)."""
    jparams = _jax_model_params(seed=3)
    rng = np.random.RandomState(36)
    x = rng.randn(N, 7).astype(np.float32)
    ei = np.asarray(jknn.knn_edge_index(jnp.asarray(x[:, :3]), K))
    weight = rng.randn(N, 6).astype(np.float32)

    def jax_run(dtype):
        model = JaxGNN(remat=False, edge_impl="fused", dtype=dtype, **KW)

        def loss(p):
            out = model.apply({"params": p}, jnp.asarray(x), jnp.asarray(ei),
                              deterministic=True)
            return jnp.sum(out * weight), out

        (_, out), grads = jax.value_and_grad(loss, has_aux=True)(jparams)
        return np.asarray(out), params_from_jax(grads)

    want16, jgrads16 = jax_run(jnp.bfloat16)
    want32, jgrads32 = jax_run(jnp.float32)
    model = NBodyGNN(dtype=torch.bfloat16, **KW)
    model.load_state_dict(params_from_jax(jparams))
    out = model.eval()(torch.from_numpy(x), torch.tensor(ei).long())
    (out * torch.from_numpy(weight)).sum().backward()
    got = out.detach().numpy()
    assert out.dtype == torch.float32
    assert _rel(got, want16) <= 1e-4
    assert np.abs(got - want32).mean() >= NEARER * np.abs(got - want16).mean()
    near = far = 0.0
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        g = p.grad.numpy()
        w16, w32 = (np.asarray(t[name]) for t in (jgrads16, jgrads32))
        assert _rel(g, w16) <= 2.0 ** -4, name
        near += np.abs(g - w16).sum()
        far += np.abs(g - w32).sum()
    assert far >= NEARER * near, (near, far)


def test_remat_leaves_losses_gradients_and_draws_unchanged():
    """With dropout on (edge stream, node MLPs, decoder), remat=True gives
    the loss and every gradient of remat=False exactly, and leaves the
    generator where it was left without remat: the layers' random values
    are drawn before the recomputed region.  ``decoder_out`` is made
    non-zero (its initialiser zeroes it, which would zero every gradient
    upstream of it), and every parameter's gradient is checked non-zero,
    so the backward pass that remat recomputes is the one compared."""
    rng = np.random.RandomState(37)
    x = torch.from_numpy(rng.randn(2, N, 7).astype(np.float32))
    ei = torch.tensor(np.asarray(jknn.knn_edge_index(
        jnp.asarray(x[0, :, :3].numpy()), K))).long()
    state = NBodyGNN(generator=torch.Generator().manual_seed(0),
                     **KW).state_dict()
    state["decoder_out.weight"] += 0.05
    for dtype in (torch.float32, torch.bfloat16):
        runs = []
        for remat in (False, True):
            model = NBodyGNN(dtype=dtype, remat=remat, **KW)
            model.load_state_dict(state)
            gen = torch.Generator().manual_seed(11)
            loss = model.train()(x, ei, generator=gen).square().mean()
            loss.backward()
            runs.append((loss.detach(), {n: p.grad for n, p in
                                         model.named_parameters()},
                         gen.get_state()))
        (l0, g0, s0), (l1, g1, s1) = runs
        assert torch.equal(l0, l1), dtype
        assert torch.equal(s0, s1), dtype
        for name in g0:
            assert g0[name].abs().max() > 0, (dtype, name)
            torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=0,
                                       msg=f"{dtype} {name}")


def test_bf16_model_keeps_float32_parameters_and_differs_from_float32():
    """Parameters and their gradients stay float32 in a bf16 model; its
    output is float32 and differs from the float32 model's by bf16
    rounding (not zero, and within 1e-2 of scale)."""
    state = NBodyGNN(generator=torch.Generator().manual_seed(1),
                     **KW).state_dict()
    state["decoder_out.weight"] += 0.05
    x = torch.from_numpy(np.random.RandomState(38).randn(N, 7)
                         .astype(np.float32))
    ei = torch.tensor(np.asarray(jknn.knn_edge_index(
        jnp.asarray(x[:, :3].numpy()), K))).long()
    outs = {}
    for dtype in ("float32", "bfloat16"):
        model = NBodyGNN(dtype=dtype, **KW)
        model.load_state_dict(state)
        outs[dtype] = model.eval()(x, ei)
        outs[dtype].sum().backward()
        assert outs[dtype].dtype == torch.float32
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
    diff = (outs["bfloat16"] - outs["float32"]).abs().max().item()
    assert 0 < diff <= 1e-2 * outs["float32"].abs().max().item()


def test_model_from_config_reads_dtype_and_remat():
    """As the JAX ``model_from_config``: ``dtype`` and ``remat`` from the
    config, ``dtype_override`` over the dtype; an unknown dtype raises."""
    with open(CONFIG) as f:
        cfg = json.load(f)["model_config"]
    assert cfg["dtype"] == "bfloat16"
    model = model_from_config(cfg)
    assert (model.dtype, model.remat) == (torch.bfloat16, False)
    assert model_from_config(cfg, dtype_override="float32").dtype == \
        torch.float32
    assert model_from_config(dict(KW)).dtype == torch.float32
    assert model_from_config(dict(KW, remat=True)).remat
    with pytest.raises(ValueError, match="dtype"):
        model_from_config(dict(KW, dtype="float16"))


def test_bf16_trained_checkpoint_loads_into_float32_model(tmp_path):
    """A Trainer checkpoint of a bf16 model (two epochs, dropout on) loads
    into a float32 model (model_from_config with dtype_override) unchanged:
    float32 parameters, equal to the trainer's (the port's counterpart of
    tests/test_model_config.py::test_bf16_and_f32_share_checkpoints)."""
    trajs = _trajectories(seed=12, n=N)
    train = GNNDataset.from_trajectories(trajs, sequence_length=5,
                                         k_neighbors=K)
    model = NBodyGNN(dtype=torch.bfloat16, **KW)
    trainer = Trainer(model, train, model_dir=str(tmp_path), device="cpu",
                      batch_size=4, seed=1)
    history = trainer.train(n_epochs=2, save_every=2, verbose=False)
    assert np.isfinite(history["train_loss"]).all()
    cfg = dict(KW, dtype="bfloat16", remat=False, edge_impl="fused")
    served = model_from_config(cfg, dtype_override="float32")
    stats = load_into(served, load_checkpoint(tmp_path / "final_model.pt"))
    assert set(stats) == {"state_mean", "state_std"}
    assert served.dtype == torch.float32
    for (name, p), q in zip(served.named_parameters(),
                            trainer.model.parameters()):
        assert p.dtype == torch.float32, name
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)


@pytest.fixture
def built_models(monkeypatch):
    """Every model the entry points build through ``model_from_config``,
    recorded; the first build stops the entry point (``_Built``)."""
    import nbody_gnn_hpc_torch.models as models

    built = []
    real = models.model_from_config

    def spy(*args, **kwargs):
        built.append(real(*args, **kwargs))
        raise _Built

    monkeypatch.setattr(models, "model_from_config", spy)
    return built


class _Built(Exception):
    pass


def test_inference_entry_points_build_float32_from_a_bf16_config(
        built_models, tmp_path):
    """models/config.json says bfloat16; serving, evaluation, checkpoint
    selection, the rollout fine-tune and the serving demo each build their
    model at float32 from it, as the JAX package's counterparts do
    (serve.py:81, scripts/evaluate.py:89, select_checkpoint.py:76,
    finetune_rollout.py:78, examples/demo_serving.py:75)."""
    from nbody_gnn_hpc_torch import (evaluate, finetune_rollout,
                                     select_checkpoint, serve)
    from nbody_gnn_hpc_torch.examples import demo_serving

    cpu = ["--device", "cpu"]
    calls = {
        "serve": lambda: serve.build_service(CKPT, CONFIG, device="cpu"),
        "evaluate": lambda: evaluate.main(
            cpu + ["-m", CKPT, "-c", CONFIG, "-o", str(tmp_path / "r")]),
        "select_checkpoint": lambda: select_checkpoint.main(
            cpu + ["-m", "models", "-c", CONFIG, "-d", str(tmp_path)]),
        "finetune_rollout": lambda: finetune_rollout.main(
            cpu + ["-m", CKPT, "-c", CONFIG, "-d", str(tmp_path)]),
        "demo_serving": lambda: demo_serving.demo_model(CKPT, str(tmp_path))}
    for name, call in calls.items():
        with pytest.raises(_Built):
            call()
        assert built_models[-1].dtype == torch.float32, name
    assert len(built_models) == len(calls)


def test_train_model_cli_writes_the_jax_config_keys(tmp_path):
    """``train_model --device cpu`` writes dtype float32 (the JAX CLI off its
    accelerator), remat and edge_impl, in the JAX CLI's order; --remat is
    recorded; --no-bf16 is accepted."""
    from nbody_gnn_hpc_torch.train_model import main

    trajs = _trajectories(seed=13, n=N)
    data = tmp_path / "data"
    data.mkdir()
    _write_windowed(data / "train_dataset.h5", trajs, 5)
    flags = ["--device", "cpu", "--data-dir", str(data), "--hidden-dim",
             str(H), "--n-layers", str(LAYERS), "--k-neighbors", str(K),
             "-b", "4", "--epochs", "1"]
    for extra, remat in (([], False), (["--remat", "--no-bf16"], True)):
        out = tmp_path / f"models{len(extra)}"
        assert main(flags + ["--model-dir", str(out)] + extra) == 0
        cfg = json.loads((out / "config.json").read_text())["model_config"]
        assert list(cfg) == ["node_input_dim", "hidden_dim", "n_layers",
                             "output_dim", "dropout", "dtype", "remat",
                             "edge_impl"]
        assert (cfg["dtype"], cfg["remat"], cfg["edge_impl"]) == (
            "float32", remat, "fused")
