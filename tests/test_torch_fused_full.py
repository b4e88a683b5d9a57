"""Whole-layer function of the port (ops/fused_edge_full.py) against the JAX
package's ``fused_full_layer``, and the ``edge_impl="fused_full"`` model
against the JAX model, on the CPU.

Inputs and weights come from a seeded numpy RNG / the JAX ``init_model`` and
go through both frameworks.  The JAX side runs its Pallas kernel in
interpret mode (as ``tests/test_fused_full.py`` does) for the layer, and its
``edge_impl="xla"`` model, which that file pins equal to ``"fused_full"`` at
1e-6, for the model.  On CPU tensors the port's wrapper runs the kernel's
plain version; the kernel itself is held against it on the card
(``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.io import params_from_jax
from nbody_gnn_hpc_torch.models import NBodyGNN, model_from_config
from nbody_gnn_hpc_torch.ops import (edge_features, fused_full_layer,
                                     fused_full_layer_plain,
                                     fused_full_layer_reference,
                                     knn_edge_index, target_csr)
from nbody_gnn_hpc_torch.ops.fused_edge_full import PARAM_KEYS
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.models.gnn import target_adjacency
from nbody_gnn_hpc_tpu.ops.edges import edge_features as jax_edge_features
from nbody_gnn_hpc_tpu.ops.fused_edge_full import \
    fused_full_layer as jax_fused_full_layer
from nbody_gnn_hpc_tpu.ops.knn import knn_edge_index as jax_knn

H, LAYERS = 32, 2
KW = dict(node_input_dim=7, hidden_dim=H, n_layers=LAYERS, output_dim=6,
          dropout=0.1)


def _layer_case(n, k, seed):
    """One layer's operands from numpy: (h, pos, edge_index, JAX-layout
    parameter dict)."""
    rng = np.random.RandomState(seed)
    pos = rng.randn(n, 3).astype(np.float32)
    h = rng.randn(n, H).astype(np.float32)
    ei = np.asarray(jax_knn(jnp.asarray(pos), k))
    mat = lambda i, o: (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)  # noqa
    vec = lambda s=0.1: (s * rng.randn(H)).astype(np.float32)  # noqa: E731
    jp = dict(wt=mat(H, H), bt=vec(), ws=mat(H, H), we=mat(5, H),
              ge=1 + vec(), be=vec(), wout=mat(H, H), bout=vec(),
              w1=mat(2 * H, H), b1=vec(), g1=1 + vec(), be1=vec(),
              w2=mat(H, H), b2=vec())
    return h, pos, ei, jp


def _torch_params(jp):
    """JAX (in, out) kernels -> the port's (out, in) tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v.T) if v.ndim == 2
                                else v) for k, v in jp.items()}


def _jax_layer(h, pos, ei, jp, k, node_mask=None):
    n = h.shape[0]
    ea = jax_edge_features(jnp.asarray(pos), jnp.asarray(ei))
    adj, deg = target_adjacency(jnp.asarray(ei), n, jnp.float32)
    mask = jnp.ones((n, H)) if node_mask is None else jnp.asarray(node_mask)
    return np.asarray(jax_fused_full_layer(
        jnp.asarray(h), ea, {k_: jnp.asarray(v) for k_, v in jp.items()},
        deg, adj.T, jnp.zeros((1, 1), jnp.int32), mask, k=k, dropout_p=0.0,
        deterministic=True, interpret=True))


def _torch_operands(h, pos, ei):
    ei_t = torch.tensor(ei).long()
    return (torch.from_numpy(h), edge_features(torch.from_numpy(pos), ei_t),
            target_csr(ei_t, h.shape[0], sources=True))


@pytest.mark.parametrize("n,k", [(32, 6), (61, 5)])
def test_reference_matches_jax_kernel_in_interpret_mode(n, k):
    """atol 1e-5: float32 summation order of six products and two
    LayerNorms."""
    h, pos, ei, jp = _layer_case(n, k, seed=n)
    want = _jax_layer(h, pos, ei, jp, k)
    ht, ea, edges = _torch_operands(h, pos, ei)
    got, summed = fused_full_layer_reference(ht, ea, _torch_params(jp), edges)
    assert summed.shape == (n, H)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # The wrapper on CPU tensors is the plain version, bit for bit.
    assert torch.equal(fused_full_layer(ht, ea, _torch_params(jp), edges),
                       got)


def test_zero_node_mask_is_inert_when_deterministic():
    h, pos, ei, jp = _layer_case(32, 6, seed=3)
    ht, ea, edges = _torch_operands(h, pos, ei)
    p = _torch_params(jp)
    seed = torch.zeros(1, dtype=torch.int32)
    ones = fused_full_layer(ht, ea, p, edges, seed, torch.ones(32, H),
                            dropout_p=0.0, deterministic=True)
    zeros = fused_full_layer(ht, ea, p, edges, seed, torch.zeros(32, H),
                             dropout_p=0.1, deterministic=True)
    assert torch.equal(ones, zeros)
    np.testing.assert_allclose(ones.numpy(), _jax_layer(
        h, pos, ei, jp, 6, node_mask=np.zeros((32, H), np.float32)),
        rtol=0, atol=1e-5)


def test_training_form_masks_and_needs_its_operands():
    h, pos, ei, jp = _layer_case(32, 6, seed=4)
    ht, ea, edges = _torch_operands(h, pos, ei)
    p = _torch_params(jp)
    seed = torch.tensor([77], dtype=torch.int32)
    mask = (torch.rand(32, H, generator=torch.Generator().manual_seed(1))
            >= 0.1).float() / 0.9
    train = fused_full_layer(ht, ea, p, edges, seed, mask, dropout_p=0.1,
                             deterministic=False)
    again = fused_full_layer(ht, ea, p, edges, seed, mask, dropout_p=0.1,
                             deterministic=False)
    assert torch.equal(train, again)
    assert not torch.equal(train, fused_full_layer(ht, ea, p, edges))
    plain = fused_full_layer_plain(ht, ea, p, edges, seed, mask,
                                   dropout_p=0.1, deterministic=False)
    torch.testing.assert_close(train, plain, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="node_mask"):
        fused_full_layer(ht, ea, p, edges, seed, None, dropout_p=0.1,
                         deterministic=False)
    with pytest.raises(ValueError, match="seed"):
        fused_full_layer(ht, ea, p, edges, None, mask, dropout_p=0.1,
                         deterministic=False)


@pytest.mark.parametrize("training", [False, True])
def test_layer_gradients_match_plain_composition(training):
    """The hand-written backward (node side by autograd, the stream through
    the edge backward, projections as products) against autograd over the
    plain composition; batched, B=2.  Tolerance 1e-5 of each gradient's
    scale: float32 summation order."""
    rng = np.random.RandomState(5)
    h, pos, ei, jp = _layer_case(20, 4, seed=5)
    hb = torch.from_numpy(np.stack([h, h[::-1].copy()]))
    posb = torch.from_numpy(np.stack([pos, pos * 0.7]))
    eib = knn_edge_index(posb, 4)
    ea = edge_features(posb, eib)
    edges = target_csr(eib, 20, sources=True)
    seed = torch.tensor([5], dtype=torch.int32) if training else None
    mask = torch.from_numpy((rng.rand(2, 20, H) >= 0.1).astype(np.float32)
                            / 0.9) if training else None
    g_out = torch.from_numpy(rng.randn(2, 20, H).astype(np.float32))

    def grads(fn):
        leaves = [hb.clone().requires_grad_(), ea.clone().requires_grad_()]
        p = {k: v.clone().requires_grad_()
             for k, v in _torch_params(jp).items()}
        out = fn(leaves[0], leaves[1], p, edges, seed, mask, dropout_p=0.1,
                 deterministic=not training)
        assert out.grad_fn is not None
        out.backward(g_out)
        return [t.grad for t in leaves + [p[k] for k in PARAM_KEYS]]

    for name, got, want in zip(("h", "edge_attr") + PARAM_KEYS,
                               grads(fused_full_layer),
                               grads(fused_full_layer_plain)):
        assert got.shape == want.shape, name
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * (want.abs().max().item() + 1e-6), (name, err)


# -- the model ---------------------------------------------------------------

def _models(seed=0, n=32, k=6):
    jparams = init_model(JaxGNN(remat=False, **KW), jax.random.PRNGKey(seed),
                         n, n * k)
    # Non-zero decoder_out so the comparison sees the whole network.
    jparams = jax.tree_util.tree_map(
        lambda p: p + 0.01 * np.sign(np.arange(p.size).reshape(p.shape) % 3
                                     - 1), jparams)
    state = params_from_jax(jparams)
    full = NBodyGNN(edge_impl="fused_full", **KW)
    fused = NBodyGNN(edge_impl="fused", **KW)
    full.load_state_dict(state)
    fused.load_state_dict(state)
    return jparams, full.eval(), fused.eval()


def _graph(n, k, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 7).astype(np.float32)
    return x, np.asarray(jax_knn(jnp.asarray(x[:, :3]), k))


def test_one_state_dict_for_both_edge_impls():
    _, full, fused = _models()
    a, b = full.state_dict(), fused.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    with pytest.raises(ValueError, match="edge_impl"):
        NBodyGNN(edge_impl="pallas", **KW)


@pytest.mark.parametrize("n,k", [(32, 6), (61, 5)])
def test_model_forward_matches_jax_and_fused(n, k):
    jparams, full, fused = _models(seed=1, n=n, k=k)
    x, ei = _graph(n, k, seed=2)
    want = np.asarray(JaxGNN(remat=False, edge_impl="xla", **KW).apply(
        {"params": jparams}, jnp.asarray(x), jnp.asarray(ei),
        deterministic=True))
    with torch.inference_mode():
        got = full(torch.from_numpy(x), torch.tensor(ei).long())
        same = fused(torch.from_numpy(x), torch.tensor(ei).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    torch.testing.assert_close(got, same, rtol=0, atol=2e-6)


def test_model_gradients_match_jax():
    """Parameter and input gradients of sum(out^2), ``fused_full`` against
    the JAX ``"xla"`` model at the tolerances of tests/test_fused_full.py
    (3e-6 of scale for parameters, 1e-5 for the input), and against the
    port's ``"fused"`` model."""
    from nbody_gnn_hpc_torch.io import params_to_jax

    n, k = 32, 6
    jparams, full, fused = _models(seed=2, n=n, k=k)
    x, ei = _graph(n, k, seed=3)
    jmodel = JaxGNN(remat=False, edge_impl="xla", **KW)

    def loss(p, xx):
        out = jmodel.apply({"params": p}, xx, jnp.asarray(ei),
                           deterministic=True)
        return jnp.sum(out * out)

    gp, gx = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    got = {}
    for name, model in (("full", full), ("fused", fused)):
        xt = torch.from_numpy(x).requires_grad_()
        model.zero_grad()
        model(xt, torch.tensor(ei).long()).square().sum().backward()
        got[name] = (xt.grad, {k_: p.grad for k_, p
                               in model.named_parameters()})
    assert set(params_to_jax(got["full"][1])) == set(gp)
    for key, w in want.items():
        g = got["full"][1][key]
        scale = max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= 3e-6 * scale, key
        assert (g - got["fused"][1][key]).abs().max().item() \
            <= 3e-6 * scale, key
    np.testing.assert_allclose(got["full"][0].numpy(), np.asarray(gx),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(got["full"][0], got["fused"][0], rtol=0,
                               atol=1e-5)


def test_model_batch_of_three_equals_per_graph():
    _, full, _ = _models(seed=3)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 32, 7).astype(np.float32))
    ei = knn_edge_index(x[..., :3], 6)
    with torch.inference_mode():
        batched = full(x, ei)
        for b in range(3):
            torch.testing.assert_close(batched[b], full(x[b], ei[b]),
                                       rtol=1e-6, atol=1e-6)


def test_training_mode_draws_the_same_masks_as_fused():
    """Edge seed, then node mask, from the caller's generator: with one
    generator seed both edge_impls apply the same dropout."""
    _, full, fused = _models(seed=4)
    x, ei = _graph(32, 6, seed=5)
    x, ei = torch.from_numpy(x), torch.tensor(ei).long()
    full.train()
    fused.train()
    a = full(x, ei, generator=torch.Generator().manual_seed(9))
    b = fused(x, ei, generator=torch.Generator().manual_seed(9))
    c = full(x, ei, generator=torch.Generator().manual_seed(10))
    torch.testing.assert_close(a, b, rtol=0, atol=2e-6)
    assert not torch.allclose(a, c, atol=1e-4)
    a.square().sum().backward()
    for name, p in full.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name


@pytest.mark.parametrize("edge_impl,want", [
    ("fused_full", "fused_full"), ("fused", "fused"), ("auto", "fused"),
    ("xla", "fused"), (None, "fused")])
def test_model_from_config_reads_edge_impl(edge_impl, want):
    cfg = dict(KW, dtype="bfloat16", remat=True, gather_mode="matmul")
    if edge_impl is not None:
        cfg["edge_impl"] = edge_impl
    model = model_from_config(cfg)
    assert model.edge_impl == want
    assert all(layer.edge_impl == want for layer in model.layers)


def test_model_from_config_refuses_unknown_edge_impl():
    with pytest.raises(ValueError, match="edge_impl"):
        model_from_config(dict(KW, edge_impl="triton"))
