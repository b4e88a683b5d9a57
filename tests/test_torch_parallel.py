"""The port's data parallelism (``nbody_gnn_hpc_torch/parallel``: mesh,
DP train step, sharded ensemble) on the CPU: 2 and 4 gloo ranks spawned on
this host (``OMP_NUM_THREADS=1``, a ``file://`` store in a temporary
directory, every rank joined within a time limit).

Against the JAX package, noise and dropout off (threefry and Philox draw
other bits): one DP step of the port at world 2 against the JAX
``make_dp_train_step`` on a 2-device virtual CPU mesh and the JAX
single-device step, both impls, both of the port's edge impls; loss rtol
1e-5, parameters rtol 1e-4 / atol 1e-6.  Within the port, noise and dropout
on: the ``gspmd`` step at world 2 and 4 equals world 1 (the kernels' plain
versions count the edge dropout's graphs from each rank's first row).
Small shapes: N=16, k=4, hidden 32, 2 layers, batch 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nbody_gnn_hpc_torch.ops import (dropout_keep, fused_edge_backward_reference,
                                     fused_edge_layer_reference,
                                     fused_full_layer_reference, knn_edge_index,
                                     target_csr)
from nbody_gnn_hpc_torch.ops.fused_edge import dropout_bits, philox4x32
from nbody_gnn_hpc_torch.parallel import (BatchSharding, pad_to_multiple,
                                          replicated, run_local_world)
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.parallel import make_dp_train_step as jax_dp_step
from nbody_gnn_hpc_tpu.parallel import make_mesh as jax_make_mesh
from nbody_gnn_hpc_tpu.train import steps as jsteps

import torch_dp_ranks as ranks

N, K, H, LAYERS, B = 16, 4, 32, 2, 8
TIMEOUT = 240.0  # seconds a spawned world may take before the test fails


def _problem():
    rng = np.random.RandomState(3)
    pos = (5 * rng.randn(N, 3)).astype(np.float32)
    edge_index = knn_edge_index(torch.from_numpy(pos), K).numpy()
    masses = rng.uniform(1e10, 1e11, N).astype(np.float32)
    states = (2 * rng.randn(2, B, N, 6)).astype(np.float32)
    targets = (states + 0.05 * rng.randn(2, B, N, 6)).astype(np.float32)
    flat = states.reshape(-1, 6)
    return dict(hidden=H, layers=LAYERS, edge_index=edge_index,
                masses=masses, states=states, targets=targets,
                mean=flat.mean(0), std=flat.std(0) + 1e-6,
                mass_feat=(masses / masses.mean())[:, None])


def _jax_params():
    params = init_model(JaxGNN(node_input_dim=7, hidden_dim=H,
                               n_layers=LAYERS, output_dim=6, remat=False,
                               dropout=0.0), jax.random.PRNGKey(0), N, N * K)
    # Non-zero decoder_out (and a nudge everywhere), so that gradients
    # reach every parameter.
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * np.sign(
            np.arange(p.size).reshape(p.shape) % 3 - 1).astype(np.float32),
        params)


def _params_close(got, want, rtol=1e-4, atol=1e-6):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]),
                                   np.asarray(want[name]), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params()


@pytest.fixture(scope="module")
def worlds(problem, jax_params):
    """world size -> every rank's :func:`torch_dp_ranks.world_checks` (at
    world 2 with the steps from the JAX weights)."""
    return {w: run_local_world(ranks.world_checks, w,
                               (problem, jax_params if w == 2 else None),
                               timeout=TIMEOUT) for w in (2, 4)}


@pytest.fixture(scope="module")
def world1(problem):
    """The single-device step of each edge impl, noise and dropout on."""
    return {**{e: ranks.dp_steps(problem, None, "gspmd", e, dropout=0.1,
                                 noise_std=0.003, n_steps=2)
               for e in ("fused", "fused_full")},
            **{f"bf16 split {w}": ranks.dp_steps(
                problem, None, "gspmd", "fused", dropout=0.1,
                noise_std=0.003, n_steps=2, dtype=torch.bfloat16, split=w)
               for w in (2, 4)},
            **{f"bf16 fused_full split {w}": ranks.dp_steps(
                problem, None, "gspmd", "fused_full", dropout=0.1,
                noise_std=0.003, n_steps=2, dtype=torch.bfloat16, split=w)
               for w in (2, 4)}}


@pytest.fixture(scope="module")
def jax_reference(problem, jax_params):
    """(loss, params) of one JAX step: single device, and DP on a 2-device
    virtual mesh for each impl (its gspmd step pins the XLA edge branch;
    the model runs it anyway here)."""
    model = JaxGNN(node_input_dim=7, hidden_dim=H, n_layers=LAYERS,
                   output_dim=6, remat=False, dropout=0.0, edge_impl="xla")
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(ranks.LR, weight_decay=ranks.WD))
    args = (problem["edge_index"], problem["mean"], problem["std"],
            problem["mass_feat"])
    kw = dict(noise_std=0.0, masses=jnp.asarray(problem["masses"]))
    p0 = jax.tree_util.tree_map(jnp.asarray, jax_params)
    s = jnp.asarray(problem["states"][0])
    t = jnp.asarray(problem["targets"][0])
    key = jax.random.PRNGKey(0)
    out = {}
    single = jax.jit(jsteps.make_train_step(model, tx, *args, **kw))
    p, _, loss = single(p0, tx.init(p0), s, t, key)
    out["single"] = (float(loss), p)
    for impl in ("gspmd", "shard_map"):
        step = jax_dp_step(model, tx, *args, jax_make_mesh(2), impl=impl,
                           **kw)
        p, _, loss = step(p0, tx.init(p0), s, t, key)
        out[impl] = (float(loss), p)
    return out


def _as_port(jax_tree):
    from nbody_gnn_hpc_torch.io.model_io import params_from_jax

    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_tree)).items()}


@pytest.mark.parametrize("edge_impl", ["fused", "fused_full"])
@pytest.mark.parametrize("impl", ["gspmd", "shard_map"])
@pytest.mark.parametrize("against", ["single", "dp"])
def test_dp_step_matches_jax(worlds, jax_reference, impl, edge_impl,
                             against):
    want_loss, want_params = jax_reference[
        "single" if against == "single" else impl]
    for rank_out in worlds[2]:
        (loss,), params = rank_out["jax"][(impl, edge_impl)]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        _params_close(params, _as_port(want_params))


def test_dp_ranks_stay_replicated(worlds):
    """Every rank ends each step with the same loss and parameters, bit
    for bit (one all-reduced gradient, then the same update)."""
    for results in [[r[part] for r in worlds[w]] for w in worlds
                    for part in ("gspmd", "jax") if part in worlds[w][0]]:
        first = results[0]
        for other in results[1:]:
            for key in first:
                assert other[key][0] == first[key][0], key
                _params_close(other[key][1], first[key][1], rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("edge_impl", ["fused", "fused_full"])
def test_gspmd_with_noise_and_dropout_equals_one_rank(worlds, world1, world,
                                                      edge_impl):
    """Each rank draws what one device draws for its rows: two steps with
    input noise and dropout 0.1 agree with the single-device steps."""
    want_losses, want_params = world1[edge_impl]
    losses, params = worlds[world][0]["gspmd"][edge_impl]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _params_close(params, want_params)


@pytest.mark.parametrize("world", [2, 4])
def test_bf16_dp_step_reduces_float32_gradients(worlds, world1, world):
    """A bf16 model (bf16 products, float32 parameters) through the
    ``gspmd`` step: what each step all-reduces, and every gradient at that
    point, is float32 (clipping and AdamW then read float32); the ranks
    stay replicated bit for bit; two steps with noise and dropout agree,
    within the float32 model's tolerance, with one device taking the same
    parts of each batch.  (Not with one device's whole batch: a bf16
    Dense's weight gradient is rounded to bf16 per part, as in the JAX
    model, and AdamW's first step turns such a rounding into the sign of an
    update.)"""
    seen = [r["bf16_reduced"] for r in worlds[world]]
    assert all(len(s) == 2 and s == [(torch.float32, {torch.float32})] * 2
               for s in seen), seen
    losses, params = worlds[world][0]["gspmd_bf16"]
    assert all(p.dtype == torch.float32 for p in params.values())
    for other in worlds[world][1:]:
        assert other["gspmd_bf16"][0] == losses
        _params_close(other["gspmd_bf16"][1], params, rtol=0, atol=0)
    want_losses, want_params = world1[f"bf16 split {world}"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _params_close(params, want_params)
    # ... and is not the float32 model's.
    assert losses != world1["fused"][0]


@pytest.mark.parametrize("world", [2, 4])
def test_bf16_fused_full_dp_step_reduces_float32_gradients(worlds, world1,
                                                           world):
    """The same for a bf16 model through kernel 7's bf16 form
    (``edge_impl="fused_full"``): float32 all-reduced gradients, ranks
    replicated bit for bit, two noisy dropout steps equal to one device
    taking the same parts of each batch, and not the float32 model's."""
    seen = [r["bf16_full_reduced"] for r in worlds[world]]
    assert all(len(s) == 2 and s == [(torch.float32, {torch.float32})] * 2
               for s in seen), seen
    losses, params = worlds[world][0]["gspmd_bf16_full"]
    assert all(p.dtype == torch.float32 for p in params.values())
    for other in worlds[world][1:]:
        assert other["gspmd_bf16_full"][0] == losses
        _params_close(other["gspmd_bf16_full"][1], params, rtol=0, atol=0)
    want_losses, want_params = world1[f"bf16 fused_full split {world}"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _params_close(params, want_params)
    assert losses != world1["fused_full"][0]


def test_shard_map_draws_its_own_bits(worlds, world1):
    """``shard_map`` folds the rank into the generator's seed: with noise
    and dropout on, its loss is finite and not the single device's."""
    (loss,), _ = worlds[2][0]["shard_map_noisy"]
    assert np.isfinite(loss)
    assert loss != world1["fused"][0][0]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ensemble_matches_unsharded(worlds, world):
    """9 systems over 2 and 4 ranks (padded to 10 and 12), gathered in seed
    order on every rank; the JAX certification's tolerance."""
    want = ranks.ensemble(None, 9)
    for rank_out in worlds[world]:
        got = rank_out["ensemble"]
        assert tuple(got.shape) == (9, 5, 8, 3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                                   atol=1e-5)


def test_hybrid_mesh_at_world_four(worlds, world1):
    """``make_hybrid_mesh(n_slices=2)``: a (2, 2) mesh named (dcn, data);
    the DP step over it and the ensemble sharded over it reproduce the
    single-device results."""
    out = worlds[4][0]
    assert out["hybrid_shape"] == (2, 2)
    assert out["hybrid_names"] == ("dcn", "data")
    want_losses, _ = ranks.dp_steps(_problem(), None, "gspmd", "fused",
                                    dropout=0.1, noise_std=0.003)
    (loss,), _ = out["hybrid_step"]
    np.testing.assert_allclose(loss, want_losses[0], rtol=1e-5)
    np.testing.assert_allclose(out["hybrid_ensemble"].numpy(),
                               ranks.ensemble(None, 9).numpy(), rtol=2e-5,
                               atol=1e-5)


# -- the graph offset of the edge dropout (kernels 1, 2 and 7) ------------


def _stream_batch(b=5, n=12, k=3, h=64, seed=0):
    rng = np.random.RandomState(seed)
    pos = torch.from_numpy(rng.randn(b, n, 3).astype(np.float32))
    ei = knn_edge_index(pos, k)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.randn(*s).astype(np.float32))
    return dict(ei=ei, n=n, tp=t(b, n, h), sp=t(b, n, h),
                ea=t(b, n * k, 5), we=t(5, h), gamma=1 + 0.1 * t(h),
                beta=0.1 * t(h), g_out=t(b, n, h), h=t(b, n, h))


SEED = torch.tensor([1234], dtype=torch.int32)
P = 0.3


def test_graph_offset_zero_is_the_unshifted_counter():
    """Offset 0 draws today's bits, and offset g draws counter (group, e,
    g + b, 0), read off Philox4x32-10 directly at a few positions."""
    bits = dropout_bits(SEED, 3, 7, 256)
    assert torch.equal(bits, dropout_bits(SEED, 3, 7, 256, graph0=0))
    shifted = dropout_bits(SEED, 3, 7, 256, graph0=40)
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    for b, e, c in ((0, 0, 0), (2, 6, 200), (1, 3, 97)):
        group, word = c % 32 + 32 * (c // 128), (c // 32) % 4
        for g0, table in ((0, bits), (40, shifted)):
            want = philox4x32(t(group), t(e), t(g0 + b), t(0), t(1234),
                              t(0))[word]
            assert int(table[b, e, c]) == int(want)


@pytest.mark.parametrize("split", [1, 2, 3, 4])
def test_split_batch_with_offsets_draws_the_unsplit_masks(split):
    """Kernel 1's, kernel 2's and kernel 7's plain versions: the two parts
    of a batch split at ``split``, the second counted from ``split``, give
    the unsplit batch's masks, outputs and per-graph gradients."""
    d = _stream_batch()
    b, e, h = d["tp"].shape[0], d["ea"].shape[1], d["tp"].shape[2]
    whole_keep = dropout_keep(SEED, P, b, e, h)
    parts = [(0, split), (split, b)]
    got_keep = torch.cat([dropout_keep(SEED, P, hi - lo, e, h, graph0=lo)
                          for lo, hi in parts])
    assert torch.equal(got_keep, whole_keep)

    def stream(lo, hi):
        csr = target_csr(d["ei"][lo:hi], d["n"], sources=True, graph0=lo)
        args = (d["tp"][lo:hi], d["sp"][lo:hi], d["ea"][lo:hi], d["we"],
                d["gamma"], d["beta"], csr)
        out = fused_edge_layer_reference(*args, SEED, P)
        grads = fused_edge_backward_reference(*args, d["g_out"][lo:hi], SEED,
                                              P)
        return out, grads

    whole_out, whole_grads = stream(0, b)
    outs, grads = zip(*(stream(lo, hi) for lo, hi in parts))
    assert torch.equal(torch.cat(outs), whole_out)
    for i in range(3):  # d_t_proj, d_s_proj, d_edge_attr: per graph
        assert torch.equal(torch.cat([g[i] for g in grads]), whole_grads[i])
    for i in range(3, 6):  # parameter gradients: summed over the graphs
        torch.testing.assert_close(grads[0][i] + grads[1][i],
                                   whole_grads[i], rtol=1e-5, atol=1e-5)

    gen = torch.Generator().manual_seed(3)
    params = {k: 0.1 * torch.randn(s, generator=gen) for k, s in (
        ("wt", (h, h)), ("bt", (h,)), ("ws", (h, h)), ("we", (h, 5)),
        ("ge", (h,)), ("be", (h,)), ("wout", (h, h)), ("bout", (h,)),
        ("w1", (h, 2 * h)), ("b1", (h,)), ("g1", (h,)), ("be1", (h,)),
        ("w2", (h, h)), ("b2", (h,)))}
    mask = (torch.rand((b, d["n"], h), generator=gen) >= P).float() / (1 - P)

    def layer(lo, hi):
        csr = target_csr(d["ei"][lo:hi], d["n"], graph0=lo)
        return fused_full_layer_reference(d["h"][lo:hi], d["ea"][lo:hi],
                                          params, csr, SEED, mask[lo:hi], P)

    whole_new, whole_summed = layer(0, b)
    new, summed = zip(*(layer(lo, hi) for lo, hi in parts))
    assert torch.equal(torch.cat(summed), whole_summed)
    torch.testing.assert_close(torch.cat(new), whole_new, rtol=1e-6,
                               atol=1e-6)


def test_graph_offset_changes_the_masks():
    """An offset is not ignored: graph 0 counted as graph 1 draws graph
    1's mask, not graph 0's."""
    keep = dropout_keep(SEED, P, 2, 9, 64)
    shifted = dropout_keep(SEED, P, 1, 9, 64, graph0=1)
    assert torch.equal(shifted[0], keep[1])
    assert not torch.equal(shifted[0], keep[0])
    with pytest.raises(ValueError, match="graph0"):
        target_csr(knn_edge_index(torch.randn(6, 3), 2), 6, graph0=-1)


# -- mesh helpers ------------------------------------------------------------


@pytest.mark.parametrize("n,count", [(8, 2), (9, 2), (9, 4), (12, 4), (3, 4)])
def test_batch_sharding_covers_the_rows_in_order(n, count):
    padded = pad_to_multiple(n, count)
    assert padded % count == 0 and 0 <= padded - n < count
    bounds = [BatchSharding(i, count).bounds(n) for i in range(count)]
    rows = [r for lo, hi in bounds for r in range(lo, hi)]
    assert rows == list(range(n))
    assert replicated(None).bounds(n) == (0, n)


def test_run_local_world_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_local_world(ranks.fail_on_rank_one, 2, timeout=TIMEOUT)
