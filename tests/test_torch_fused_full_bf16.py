"""Kernel 7's bf16 form (``edge_impl="fused_full"`` in a bfloat16 model) in
the port against the JAX package's, on the CPU.

The JAX kernel's bf16 form (``cd = bfloat16``, the form its accelerator runs
for a bf16 model) is reached as in ``tests/test_torch_bf16.py``: the JAX
wrapper called with ``interpret=False`` while ``pl.pallas_call`` is made to
interpret.  The JAX side is compiled with XLA's excess precision off
(``xla_allow_excess_precision``, a per-compilation option): with it on, the
CPU compiler keeps some of the kernel's bf16 intermediates in float32, so
the interpreted kernel would skip roundings that the TPU kernel makes.
Nothing in the JAX package changes.  Small sizes (hidden 32, 2 layers, N=32
and an odd N=13, k=8 / 4); inputs from seeded numpy RNGs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nbody_gnn_hpc_tpu.ops.fused_edge_full as jfull
from nbody_gnn_hpc_torch.io import params_from_jax
from nbody_gnn_hpc_torch.models import (NBodyGNN, ParticleInteractionLayer,
                                        model_from_config)
from nbody_gnn_hpc_torch.ops import (edge_features, fused_full_layer,
                                     fused_full_layer_plain,
                                     fused_full_layer_reference, target_csr)
from nbody_gnn_hpc_torch.ops.fused_edge_full import PARAM_KEYS
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.models.gnn import target_adjacency
from nbody_gnn_hpc_tpu.ops.edges import edge_features as jax_edge_features
from nbody_gnn_hpc_tpu.ops.knn import knn_edge_index as jax_knn

H, LAYERS = 32, 2
KW = dict(node_input_dim=7, hidden_dim=H, n_layers=LAYERS, output_dim=6,
          dropout=0.1)
CONFIG = "models/config.json"  # says "dtype": "bfloat16"
# The port's bf16 layer against JAX kernel 7's bf16 form: the same roundings
# at the same places, so what is left is float32 summation order (LayerNorm
# means, the target sums, the 2H-deep product of z1), 1e-5 of each tensor's
# scale.  JAX's float32 form on the same bf16 weights is ~5e-3 of scale away
# (the rounded products and activations): the port must be nearer the bf16
# form than the float32 one by at least NEARER, in the mean.
BF16_REL = 1e-5
NEARER = 2.0
GRAD_NAMES = ("h", "edge_attr") + PARAM_KEYS
JAX_LAYER = jfull.fused_full_layer  # unpatched: interpret= chooses the form


@pytest.fixture
def tpu_bf16_full(monkeypatch):
    """The JAX whole-layer wrapper's bf16 form on the CPU: ``interpret=
    False`` selects ``cd = bfloat16`` (as on the accelerator), and every
    ``pallas_call`` runs in interpret mode.  The model imports the wrapper
    at call time, so the patched one reaches it."""
    call = pl.pallas_call

    def interpreted(*args, **kwargs):
        return call(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    layer = jfull.fused_full_layer
    monkeypatch.setattr(jfull, "fused_full_layer", lambda *a, **kw: layer(
        *a, **{**kw, "interpret": False}))


def _exact(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off, so each bf16
    cast rounds."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _layer_case(n, k, seed):
    """One layer's operands from numpy: (h, pos, edge_index, JAX-layout
    parameters, an upstream gradient)."""
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
    return h, pos, ei, jp, rng.randn(n, H).astype(np.float32)


def _jax_layer(h, pos, ei, jp, k, g_out, interpret):
    """(out, {name: cotangent}) of the JAX layer with bf16 wt and ws: its
    bf16 form (``interpret=False`` under the fixture), or its float32 form
    on the same bf16 weights (``interpret=True``)."""
    n = h.shape[0]
    ea = jax_edge_features(jnp.asarray(pos), jnp.asarray(ei))
    adj, deg = target_adjacency(jnp.asarray(ei), n, jnp.float32)
    params = {key: jnp.asarray(v) for key, v in jp.items()}
    for key in ("wt", "ws"):
        params[key] = params[key].astype(jnp.bfloat16)

    def run(hh, eaa, pp, g):
        out, vjp = jax.vjp(lambda *a: JAX_LAYER(
            *a, deg, adj.T, jnp.zeros((1, 1), jnp.int32), jnp.ones((n, H)),
            k=k, interpret=interpret), hh, eaa, pp)
        return out, vjp(g)

    out, (gh, gea, gp) = _exact(run, jnp.asarray(h), ea, params,
                                jnp.asarray(g_out))
    grads = {"h": gh, "edge_attr": gea, **gp}
    return np.asarray(out), {key: np.asarray(v, np.float32).T
                             if v.ndim == 2 and key in PARAM_KEYS
                             else np.asarray(v, np.float32)
                             for key, v in grads.items()}


def _torch_params(jp, bf16=True):
    """JAX (in, out) kernels -> the port's (out, in) tensors; wt and ws in
    bf16 for the bf16 form."""
    p = {key: torch.from_numpy(np.ascontiguousarray(v.T) if v.ndim == 2
                               else v) for key, v in jp.items()}
    if bf16:
        p["wt"], p["ws"] = p["wt"].bfloat16(), p["ws"].bfloat16()
    return p


def _operands(h, pos, ei):
    ei_t = torch.tensor(ei).long()
    return (torch.from_numpy(h), edge_features(torch.from_numpy(pos), ei_t),
            target_csr(ei_t, h.shape[0], sources=True))


def _rel(got, want) -> float:
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _bf16_exact(t: torch.Tensor) -> bool:
    t = t.float()
    return torch.equal(t, t.bfloat16().float())


def _port_layer(h, pos, ei, jp, g_out):
    """(out, {name: gradient}) of the port's bf16 layer on CPU tensors (the
    wrapper: the plain forward and the custom backward)."""
    ht, ea, edges = _operands(h, pos, ei)
    leaves = {"h": ht.requires_grad_(), "edge_attr": ea.requires_grad_(),
              **{key: v.requires_grad_()
                 for key, v in _torch_params(jp).items()}}
    out = fused_full_layer(leaves["h"], leaves["edge_attr"],
                           {key: leaves[key] for key in PARAM_KEYS}, edges)
    out.backward(torch.from_numpy(g_out))
    return out.detach(), {key: t.grad for key, t in leaves.items()}


@pytest.mark.parametrize("n,k", [(32, 8), (13, 4)])
def test_bf16_layer_matches_jax_kernel7_bf16_form(tpu_bf16_full, n, k):
    """Forward within BF16_REL of the JAX bf16 form's scale and NEARER
    times nearer it than JAX's float32 form on the same bf16 weights; all
    16 gradients (h, edge_attr and the 14 parameters) against JAX's custom
    VJP within BF16_REL of each one's scale and NEARER times nearer it (but
    d_b2, the sum of g_out in both forms); d_wt and d_ws bf16 (the
    cotangent of the cast) and bf16-exact, the other gradients float32 and
    not all bf16-exact."""
    h, pos, ei, jp, g_out = _layer_case(n, k, seed=n + 100)
    want16, jgrads16 = _jax_layer(h, pos, ei, jp, k, g_out, interpret=False)
    want32, jgrads32 = _jax_layer(h, pos, ei, jp, k, g_out, interpret=True)
    got, grads = _port_layer(h, pos, ei, jp, g_out)
    assert got.dtype == torch.float32 and got.shape == (n, H)
    assert _rel(got, want16) <= BF16_REL
    far = np.abs(got.numpy() - want32).mean()
    assert far >= NEARER * np.abs(got.numpy() - want16).mean()
    assert far > 1e-3 * np.abs(want16).mean()  # the forms differ here
    for name in GRAD_NAMES:
        g = grads[name]
        bf16 = name in ("wt", "ws")
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32), name
        assert _rel(g.float(), jgrads16[name]) <= BF16_REL, name
        near = np.abs(g.float().numpy() - jgrads16[name]).mean()
        assert name == "b2" or np.abs(
            g.float().numpy() - jgrads32[name]).mean() >= NEARER * near, name
        if bf16:
            assert _bf16_exact(g), name
    assert not all(_bf16_exact(grads[name]) for name in GRAD_NAMES
                   if name not in ("wt", "ws"))


def _layer_module(jp, edge_impl):
    """A bf16 ``ParticleInteractionLayer`` holding ``jp``."""
    layer = ParticleInteractionLayer(H, H, dropout=0.1, edge_impl=edge_impl,
                                     dtype=torch.bfloat16)
    p = _torch_params(jp, bf16=False)
    with torch.no_grad():
        for key, t in layer.full_layer_params().items():
            t.copy_(p[key])
    return layer.eval()


@pytest.mark.parametrize("n,k", [(32, 8), (13, 4)])
def test_bf16_whole_layer_follows_kernel7_not_the_composed_layer(
        tpu_bf16_full, n, k):
    """A bf16 layer with ``edge_impl="fused_full"`` is nearer JAX kernel 7's
    bf16 form, by NEARER in the mean, than the port's bf16 ``"fused"``
    layer on the same weights is: the node side follows kernel 7's casts
    (agg in float32), not the composed layer's ``_AggregatedDense`` (agg
    rounded to bf16).  It passes Wt and Ws cast to bf16, so the layer's
    float32 parameters get bf16-exact gradients there."""
    h, pos, ei, jp, g_out = _layer_case(n, k, seed=n + 200)
    want16, _ = _jax_layer(h, pos, ei, jp, k, g_out, interpret=False)
    ht, ea, edges = _operands(h, pos, ei)
    deg = edges.degree[0]
    full, fused = (_layer_module(jp, e) for e in ("fused_full", "fused"))
    got = full(ht, ea, edges, deg)
    composed = fused(ht, ea, edges, deg).detach().numpy()
    near = np.abs(got.detach().numpy() - want16).mean()
    assert _rel(got.detach(), want16) <= BF16_REL
    assert np.abs(composed - want16).mean() >= NEARER * near
    got.backward(torch.from_numpy(g_out))
    for key, t in full.full_layer_params().items():
        assert t.dtype == torch.float32 and t.grad.dtype == torch.float32
        assert _bf16_exact(t.grad) == (key in ("wt", "ws")), key


def _jax_model_params(seed, n, k):
    jparams = init_model(JaxGNN(remat=False, **KW),
                         jax.random.PRNGKey(seed), n, n * k)
    # Non-zero decoder_out (a nudge everywhere) so the whole network shows.
    return jax.tree_util.tree_map(
        lambda p: p + 0.01 * np.sign(np.arange(p.size).reshape(p.shape) % 3
                                     - 1), jparams)


# The biases of the bf16 Denses around the layers (encoder, decoder): XLA
# sums their gradients in bf16, the port in float32 (a few bf16 steps).
DENSE_BIASES = ("node_encoder.Dense_0.bias", "node_encoder.Dense_1.bias",
                "decoder_0.bias", "decoder_1.bias")


@pytest.mark.parametrize("n,k", [(20, 8), (13, 4)])
def test_bf16_fused_full_model_matches_jax(tpu_bf16_full, n, k):
    """NBodyGNN(dtype=torch.bfloat16, edge_impl="fused_full") against the
    JAX NBodyGNN(dtype=jnp.bfloat16, edge_impl="fused_full") on the same
    weights (``params_from_jax``), 2-D inputs: the output within BF16_REL
    of its scale and every parameter's gradient (of a fixed weighting of
    the outputs) within BF16_REL of its scale, but DENSE_BIASES within 2^-4;
    both NEARER times nearer the JAX bf16 model than the JAX float32 model
    of the same weights (in the mean; over every parameter for the
    gradients).  N is not a multiple of 8 (the JAX layer pads it): at
    N = 16, 24 or 32 XLA's CPU runtime refuses one of the JAX bf16 model's
    bf16 x bf16 -> f32 products ("Unsupported element type for DotThunk"),
    with excess precision on or off; the layer test above covers N=32."""
    jparams = _jax_model_params(seed=5, n=n, k=k)
    rng = np.random.RandomState(n + 300)
    x = rng.randn(n, 7).astype(np.float32)
    ei = np.asarray(jax_knn(jnp.asarray(x[:, :3]), k))
    weight = rng.randn(n, 6).astype(np.float32)

    def jax_run(dtype):
        model = JaxGNN(remat=False, edge_impl="fused_full", dtype=dtype,
                       **KW)

        def loss(p):
            out = model.apply({"params": p}, jnp.asarray(x), jnp.asarray(ei),
                              deterministic=True)
            return jnp.sum(out * weight), out

        (_, out), grads = _exact(jax.value_and_grad(loss, has_aux=True),
                                 jparams)
        return np.asarray(out), params_from_jax(grads)

    want16, jgrads16 = jax_run(jnp.bfloat16)
    want32, jgrads32 = jax_run(jnp.float32)
    model = NBodyGNN(dtype=torch.bfloat16, edge_impl="fused_full", **KW)
    model.load_state_dict(params_from_jax(jparams))
    out = model.eval()(torch.from_numpy(x), torch.tensor(ei).long())
    (out * torch.from_numpy(weight)).sum().backward()
    got = out.detach().numpy()
    assert out.dtype == torch.float32
    assert _rel(got, want16) <= BF16_REL
    assert np.abs(got - want32).mean() >= NEARER * np.abs(got - want16).mean()
    near = far = 0.0
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        g = p.grad.numpy()
        w16, w32 = (np.asarray(t[name]) for t in (jgrads16, jgrads32))
        assert _rel(g, w16) <= (2.0 ** -4 if name in DENSE_BIASES
                                else BF16_REL), name
        near += np.abs(g - w16).sum()
        far += np.abs(g - w32).sum()
    assert far >= NEARER * near, (near, far)


def test_bf16_layer_on_cpu_counts_no_launch_and_refuses_a_mixed_pair():
    """On CPU tensors the wrapper runs the plain bf16 version (no launch
    counted in either form, the result bit-equal to the reference); wt and
    ws of different dtypes are refused in every entry point."""
    h, pos, ei, jp, _ = _layer_case(32, 8, seed=7)
    ht, ea, edges = _operands(h, pos, ei)
    p = _torch_params(jp)
    counts = (fused_full_layer.launches, fused_full_layer.bf16_launches)
    got = fused_full_layer(ht, ea, p, edges)
    assert (fused_full_layer.launches, fused_full_layer.bf16_launches) == \
        counts
    assert torch.equal(got, fused_full_layer_reference(ht, ea, p, edges)[0])
    mixed = dict(p, ws=p["ws"].float())
    for fn in (fused_full_layer, fused_full_layer_plain,
               fused_full_layer_reference):
        with pytest.raises(TypeError, match="one dtype"):
            fn(ht, ea, mixed, edges)


@pytest.mark.parametrize("bf16", [False, True])
def test_backward_reference_is_the_wrappers_backward_on_the_cpu(bf16):
    """``fused_full_layer_backward_reference`` (the yardstick of the custom
    backward on the card) is, on CPU tensors, what the wrapper's backward
    computes, bit for bit, in training form and batched (B=2), in both
    forms; in the bf16 form d_wt and d_ws are bf16."""
    from nbody_gnn_hpc_torch.ops import fused_full_layer_backward_reference

    rng = np.random.RandomState(12)
    _, _, _, jp, _ = _layer_case(20, 4, seed=13)
    pos = torch.from_numpy(rng.randn(2, 20, 3).astype(np.float32))
    ei = torch.stack([torch.tensor(np.asarray(jax_knn(jnp.asarray(
        pos[b].numpy()), 4))) for b in range(2)]).long()
    h = torch.from_numpy(rng.randn(2, 20, H).astype(np.float32))
    ea = edge_features(pos, ei)
    edges = target_csr(ei, 20, sources=True)
    seed = torch.tensor([21], dtype=torch.int32)
    mask = (torch.from_numpy(rng.rand(2, 20, H)) >= 0.1).float() / 0.9
    g_out = torch.from_numpy(rng.randn(2, 20, H).astype(np.float32))
    p = _torch_params(jp, bf16)
    leaves = [h.clone().requires_grad_(), ea.clone().requires_grad_()]
    params = {key: t.clone().requires_grad_() for key, t in p.items()}
    fused_full_layer(leaves[0], leaves[1], params, edges, seed, mask,
                     dropout_p=0.1, deterministic=False).backward(g_out)
    got = [t.grad for t in leaves + [params[key] for key in PARAM_KEYS]]
    want = fused_full_layer_backward_reference(h, ea, p, edges, g_out, seed,
                                               mask, 0.1)
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert g.dtype == w.dtype == (torch.bfloat16 if bf16 and name in (
            "wt", "ws") else torch.float32), name
        assert torch.equal(g, w), name


def test_bf16_plain_draws_the_float32_forms_dropout_masks():
    """With one edge into each target, the bf16 plain version's sums are
    zero exactly where the float32 one's are (the same Philox mask, about a
    tenth of the channels), and its output differs from the float32
    form's by bf16 rounding; in training the node mask applies to both."""
    rng = np.random.RandomState(8)
    n = 64
    row = torch.from_numpy(rng.permutation(n)).long()
    ei = torch.stack([row, torch.arange(n)])  # target t from one source
    pos = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
    h = torch.from_numpy(rng.randn(n, H).astype(np.float32))
    ea = edge_features(pos, ei)
    edges = target_csr(ei, n)
    _, _, _, jp, _ = _layer_case(n, 4, seed=9)
    seed = torch.tensor([11], dtype=torch.int32)
    mask = (torch.from_numpy(rng.rand(n, H)) >= 0.1).float() / 0.9
    outs = {}
    for bf16 in (False, True):
        outs[bf16] = fused_full_layer_reference(
            h, ea, _torch_params(jp, bf16), edges, seed, mask, 0.1)
    (h32, s32), (h16, s16) = outs[False], outs[True]
    dropped = s32 == 0
    assert 0.05 < dropped.float().mean() < 0.15
    assert torch.equal(s16 == 0, dropped)
    diff = (h16 - h32).abs().max().item()
    assert 0 < diff <= 5e-2 * h32.abs().max().item()


def test_bf16_whole_layer_remat_leaves_losses_gradients_and_draws_unchanged():
    """A bf16 ``fused_full`` model with dropout on (edge stream, node MLPs,
    decoder): remat=True gives the loss and every gradient of remat=False
    exactly and leaves the generator where it was left without remat (the
    layers' random values are drawn before the recomputed region); every
    parameter's gradient is non-zero."""
    rng = np.random.RandomState(10)
    x = torch.from_numpy(rng.randn(2, 32, 7).astype(np.float32))
    ei = torch.tensor(np.asarray(jax_knn(jnp.asarray(x[0, :, :3].numpy()),
                                         8))).long()
    state = NBodyGNN(generator=torch.Generator().manual_seed(2),
                     **KW).state_dict()
    state["decoder_out.weight"] += 0.05
    runs = []
    for remat in (False, True):
        model = NBodyGNN(dtype=torch.bfloat16, edge_impl="fused_full",
                         remat=remat, **KW)
        model.load_state_dict(state)
        gen = torch.Generator().manual_seed(12)
        loss = model.train()(x, ei, generator=gen).square().mean()
        loss.backward()
        runs.append((loss.detach(), {name: p.grad for name, p in
                                     model.named_parameters()},
                     gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1)
    assert torch.equal(s0, s1)
    for name in g0:
        assert g0[name].abs().max() > 0, name
        torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=0,
                                   msg=name)


def test_bf16_fused_full_model_from_config_runs_with_float32_parameters():
    """The bf16 model of ``models/config.json`` (production width) with
    ``edge_impl="fused_full"`` builds, runs forward and backward on the CPU
    in its bf16 form (its output is not the float32 model's) and keeps
    float32 parameters and gradients."""
    with open(CONFIG) as f:
        cfg = dict(json.load(f)["model_config"], edge_impl="fused_full")
    assert cfg["dtype"] == "bfloat16"
    model = model_from_config(cfg)
    assert (model.dtype, model.edge_impl) == (torch.bfloat16, "fused_full")
    with torch.no_grad():
        model.decoder_out.weight.normal_(
            0, 0.05, generator=torch.Generator().manual_seed(3))
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(24, 7).astype(np.float32))
    ei = torch.tensor(np.asarray(jax_knn(jnp.asarray(x[:, :3].numpy()),
                                         6))).long()
    out = model.eval()(x, ei)
    out.square().sum().backward()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    f32 = model_from_config(cfg, dtype_override="float32")
    f32.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert not torch.equal(f32.eval()(x, ei), out.detach())
