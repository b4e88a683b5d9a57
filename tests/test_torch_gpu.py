"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (``nvcc``); without a
card they skip.  They import no JAX, so on a machine without it run them
as ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.ops import (fused_edge_backward,
                                     fused_edge_backward_reference,
                                     fused_edge_layer,
                                     fused_edge_layer_reference,
                                     knn_edge_index, target_csr)

pytestmark = pytest.mark.gpu

# float32 on both sides; the kernel and scatter_add_ sum the ~k messages of
# a target in different orders (reduction order only).
TOL = dict(rtol=1e-4, atol=1e-4)
# Parameter gradients sum B*E edge terms (up to 192k at B=24) in another
# order than the plain version's einsum/sum: float32 reduction order only,
# relative to the scale of each gradient.
GRAD_RTOL = 1e-4
NAMES = ("d_t_proj", "d_s_proj", "d_edge_attr", "d_w_e", "d_gamma", "d_beta")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(b, n, k, h, device, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa
    pos = t(rng.rand(b, n, 3) * 10 - 5)
    edges = target_csr(knn_edge_index(pos, k), n, sources=True)
    return (t(rng.randn(b, n, h)), t(rng.randn(b, n, h)),
            t(rng.randn(b, n * k, 5)), t(rng.randn(5, h) * 0.3),
            t(1 + 0.1 * rng.randn(h)), t(0.1 * rng.randn(h)), edges)


def _seed(device, value=12345):
    return torch.tensor([value], dtype=torch.int32, device=device)


def _assert_grads_close(got, want):
    for name, g, w in zip(NAMES, got, want):
        scale = w.abs().max().item() + 1e-6
        err = (g - w).abs().max().item()
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("b,n,k,h", [(1, 200, 40, 256), (8, 200, 40, 256),
                                     (1, 13, 4, 256), (2, 37, 5, 32),
                                     (3, 50, 7, 96)])
def test_kernel_matches_plain_version(cuda, b, n, k, h):
    args = _inputs(b, n, k, h, cuda, seed=n + h)
    before = fused_edge_layer.launches
    got = fused_edge_layer(*args)
    torch.cuda.synchronize()
    assert fused_edge_layer.launches == before + 1
    torch.testing.assert_close(got, fused_edge_layer_reference(*args), **TOL)


@pytest.mark.parametrize("b,n,k,h", [(1, 200, 40, 256), (24, 200, 40, 256),
                                     (2, 13, 4, 96)])
def test_dropout_kernel_matches_plain_version(cuda, b, n, k, h):
    args = _inputs(b, n, k, h, cuda, seed=3 * n + h)
    got = fused_edge_layer(*args, _seed(cuda), dropout_p=0.1,
                           deterministic=False)
    want = fused_edge_layer_reference(*args, _seed(cuda), 0.1)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("b", [1, 24])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_backward_kernel_matches_plain_version(cuda, b, p):
    args = _inputs(b, 200, 40, 256, cuda, seed=b)
    g_out = torch.randn_like(args[0])
    seed = _seed(cuda, 777) if p else None
    before = fused_edge_backward.launches
    got = fused_edge_backward(*args, g_out, seed, p)
    torch.cuda.synchronize()
    assert fused_edge_backward.launches == before + 1
    _assert_grads_close(got, fused_edge_backward_reference(
        *args, g_out, seed, p))


def test_backward_odd_shape_and_no_d_edge_attr(cuda):
    args = _inputs(2, 13, 4, 96, cuda, seed=5)
    g_out = torch.randn_like(args[0])
    got = fused_edge_backward(*args, g_out, _seed(cuda), 0.25,
                              need_d_edge_attr=False)
    want = fused_edge_backward_reference(*args, g_out, _seed(cuda), 0.25)
    assert got[2] is None
    _assert_grads_close(got[:2] + got[3:], want[:2] + want[3:])


def test_gradients_reach_every_input_through_the_layer(cuda):
    """On CUDA the layer is differentiable (kernel 2 is its backward) and
    its gradients equal the plain version's, in eval and training form."""
    tp, sp, ea, we, gamma, beta, edges = _inputs(4, 200, 40, 256, cuda, 9)
    g_out = torch.randn_like(tp)
    for p, det in ((0.1, True), (0.1, False)):
        leaves = [t.clone().requires_grad_() for t in (tp, sp, ea, we, gamma,
                                                       beta)]
        out = fused_edge_layer(*leaves, edges, _seed(cuda), dropout_p=p,
                               deterministic=det)
        assert out.grad_fn is not None
        before = fused_edge_backward.launches
        out.backward(g_out)
        assert fused_edge_backward.launches == before + 1
        want = fused_edge_backward_reference(
            tp, sp, ea, we, gamma, beta, edges, g_out,
            None if det else _seed(cuda), 0.0 if det else p)
        _assert_grads_close([t.grad for t in leaves], want)


def test_kernel_reruns_are_bit_identical(cuda):
    args = _inputs(8, 200, 40, 256, cuda, seed=1)
    first = fused_edge_layer(*args, _seed(cuda), dropout_p=0.1,
                             deterministic=False)
    second = fused_edge_layer(*args, _seed(cuda), dropout_p=0.1,
                              deterministic=False)
    assert torch.equal(first, second)


def test_backward_reruns_are_bit_identical(cuda):
    args = _inputs(24, 200, 40, 256, cuda, seed=2)
    g_out = torch.randn_like(args[0])
    first = fused_edge_backward(*args, g_out, _seed(cuda), 0.1)
    second = fused_edge_backward(*args, g_out, _seed(cuda), 0.1)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


def test_unbatched_call_equals_batch_of_one(cuda):
    args = _inputs(1, 50, 6, 64, cuda, seed=2)
    lone = [a[0] for a in args[:3]] + list(args[3:])
    assert torch.equal(fused_edge_layer(*lone), fused_edge_layer(*args)[0])


def test_wrapper_rejects_bad_operands(cuda):
    args = list(_inputs(1, 20, 4, 64, cuda, seed=3))
    with pytest.raises(TypeError):
        fused_edge_layer(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_edge_layer(args[0].transpose(1, 2).contiguous().transpose(
            1, 2), *args[1:])
    with pytest.raises(ValueError, match="multiple of 32"):
        bad = _inputs(1, 20, 4, 48, cuda, seed=4)
        fused_edge_layer(*bad)


# The bf16 stream (kernels 1 and 2 with bf16 t_proj / s_proj) against its
# plain bf16 version.  Where a float32 difference of the two (the kernel's
# approximate sigmoid, the sum order) moves a value across a bf16 rounding
# boundary, the result moves by that value's bf16 step, 2^-8 of it: the
# largest error may reach BF16_MAX_OF_SCALE of the result's scale, and at
# most BF16_SHARE of the elements may lie beyond the float32 bound (1e-4 of
# scale).  A stream that rounded nothing, or rounded elsewhere, puts most
# elements beyond it.
BF16_MAX_OF_SCALE, BF16_SHARE = 2.0 ** -7, 1e-2


def _assert_bf16_close(got, want, name="", max_of_scale=BF16_MAX_OF_SCALE,
                       most_beyond=BF16_SHARE):
    got, want = got.float(), want.float()
    scale = want.abs().max().item() + 1e-6
    err = (got - want).abs()
    share = (err > 1e-4 * scale).float().mean().item()
    assert err.max().item() <= max_of_scale * scale, (name, scale)
    assert share <= most_beyond, (name, share)


def _bf16(args):
    return (args[0].bfloat16(), args[1].bfloat16()) + tuple(args[2:])


@pytest.mark.parametrize("b,n,k,h,p", [
    (1, 200, 40, 256, 0.0), (8, 200, 40, 256, 0.0), (10, 200, 40, 256, 0.0),
    (1, 200, 40, 256, 0.1), (24, 200, 40, 256, 0.1), (2, 37, 5, 32, 0.1),
    (3, 50, 7, 96, 0.0)])
def test_bf16_kernel_matches_plain_version(cuda, b, n, k, h, p):
    """Kernel 1's bf16 form (the production shapes of serving, evaluation
    and B=24 training, and odd ones): against the plain bf16 version,
    counted as a bf16 launch and not as a float32 one."""
    args = _bf16(_inputs(b, n, k, h, cuda, seed=5 * n + h + b))
    seed = _seed(cuda) if p else None
    before = (fused_edge_layer.launches, fused_edge_layer.bf16_launches)
    got = fused_edge_layer(*args, seed, dropout_p=p, deterministic=not p)
    torch.cuda.synchronize()
    assert (fused_edge_layer.launches, fused_edge_layer.bf16_launches) == (
        before[0], before[1] + 1)
    assert got.dtype == torch.float32
    _assert_bf16_close(got, fused_edge_layer_reference(*args, seed, p))
    again = fused_edge_layer(*args, seed, dropout_p=p, deterministic=not p)
    assert torch.equal(got, again)


@pytest.mark.parametrize("b,p,d_ea", [(1, 0.1, False), (24, 0.1, False),
                                      (8, 0.0, True), (3, 0.25, True)])
def test_bf16_backward_kernel_matches_plain_version(cuda, b, p, d_ea):
    """Kernel 2's bf16 form (batch folded): d_t_proj and d_s_proj in bf16
    within the bf16 bound, the float32 four within GRAD_RTOL (they come
    from the unrounded dz of the same bf16 inputs); a bf16 launch."""
    args = _bf16(_inputs(b, 200, 40, 256, cuda, seed=40 + b))
    g_out = torch.randn(args[0].shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(b))
    seed = _seed(cuda, 99) if p else None
    before = (fused_edge_backward.launches,
              fused_edge_backward.bf16_launches)
    got = fused_edge_backward(*args, g_out, seed, p, need_d_edge_attr=d_ea)
    torch.cuda.synchronize()
    assert (fused_edge_backward.launches,
            fused_edge_backward.bf16_launches) == (before[0], before[1] + 1)
    want = fused_edge_backward_reference(*args, g_out, seed, p)
    assert [g.dtype for g in got[:2]] == [torch.bfloat16] * 2
    for name, g, w in zip(NAMES[:2], got[:2], want[:2]):
        _assert_bf16_close(g, w, name)
    rest = [(n, g, w) for n, g, w in zip(NAMES[2:], got[2:], want[2:])
            if g is not None]
    assert len(rest) == (4 if d_ea else 3)
    _assert_grads_close([g for _, g, _ in rest], [w for _, _, w in rest])
    again = fused_edge_backward(*args, g_out, seed, p, need_d_edge_attr=d_ea)
    assert all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got, again))


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_bf16_kernels_round_the_float32_kernels_terms(cuda, p):
    """With one edge into and out of each node, both forms on the card are
    exactly related: kernel 1's bf16 result is its float32 result rounded
    to bf16; with a g_out that bf16 holds exactly, kernel 2's d_t_proj and
    d_s_proj are the float32 kernel's rounded to bf16 and the other four
    equal the float32 kernel's.  So the bf16 form rounds where the TPU
    kernel does, and both forms draw the same dropout mask."""
    b, n, h = 3, 200, 256
    rng = np.random.RandomState(7)
    ei = torch.from_numpy(np.stack([np.stack(
        [rng.permutation(n), np.arange(n)]) for _ in range(b)])).to(cuda)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa
    tp = t(rng.randn(b, n, h)).bfloat16().float()
    sp = t(rng.randn(b, n, h)).bfloat16().float()
    rest = (t(rng.randn(b, n, 5)), t(rng.randn(5, h) * 0.3),
            t(1 + 0.1 * rng.randn(h)), t(0.1 * rng.randn(h)),
            target_csr(ei, n, sources=True))
    seed = _seed(cuda, 5) if p else None
    kw = dict(dropout_p=p, deterministic=not p)
    f32 = fused_edge_layer(tp, sp, *rest, seed, **kw)
    got = fused_edge_layer(tp.bfloat16(), sp.bfloat16(), *rest, seed, **kw)
    assert torch.equal(got, f32.bfloat16().float())
    g_out = t(rng.randn(b, n, h)).bfloat16().float()
    g32 = fused_edge_backward(tp, sp, *rest, g_out, seed, p)
    g16 = fused_edge_backward(tp.bfloat16(), sp.bfloat16(), *rest, g_out,
                              seed, p)
    for name, x, y in zip(NAMES[:2], g16[:2], g32[:2]):
        assert torch.equal(x, y.bfloat16()), name
    for name, x, y in zip(NAMES[2:], g16[2:], g32[2:]):
        assert torch.equal(x, y), name


def test_bf16_model_on_the_card_runs_the_bf16_kernels(cuda):
    """A bf16 NBodyGNN at the production width trains through the bf16
    forms only (6 forward and 6 backward launches a step, no float32
    ones); its loss and gradients agree with its plain-version path on
    the card (same seeds and masks): the loss within 1e-3 relative, each
    parameter's gradient within 5e-2 of its scale (bf16 steps carried
    through six layers)."""
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.ops import fused_edge_layer_plain

    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(4, 200, 7).astype(np.float32)).to(cuda)
    ei = knn_edge_index(x[..., :3], 40)
    runs = []
    for plain in (False, True):
        model = NBodyGNN(hidden_dim=256, n_layers=6, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0)).to(cuda)
        with torch.no_grad():
            model.decoder_out.weight.fill_(0.01)
        if plain:
            for layer in model.layers:
                layer.edge_stream = fused_edge_layer_plain
        counts = (fused_edge_layer.launches, fused_edge_backward.launches,
                  fused_edge_layer.bf16_launches,
                  fused_edge_backward.bf16_launches)
        gen = torch.Generator(cuda).manual_seed(3)
        loss = model.train()(x, ei, generator=gen).square().mean()
        loss.backward()
        torch.cuda.synchronize()
        moved = [a - c for a, c in zip(
            (fused_edge_layer.launches, fused_edge_backward.launches,
             fused_edge_layer.bf16_launches,
             fused_edge_backward.bf16_launches), counts)]
        assert moved == ([0, 0, 0, 0] if plain else [0, 0, 6, 6])
        runs.append((loss.item(), {n: q.grad for n, q in
                                   model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert abs(l0 - l1) <= 1e-3 * abs(l1)
    for name in g0:
        assert g0[name].dtype == torch.float32
        scale = g1[name].abs().max().item() + 1e-12
        assert (g0[name] - g1[name]).abs().max().item() <= 5e-2 * scale, name


# Kernel 1 splits the CSR into equal runs of edges, whatever their targets:
# graphs whose in-degrees are far from even.

def _graph(kind, b, n, rng):
    """(B, 2, E) int64 edges of one kind, made with numpy."""
    graphs = []
    for _ in range(b):
        if kind == "hub":  # one target holds ~80 % of the edges
            e = 40 * n
            col = np.where(rng.rand(e) < 0.8, n // 3, rng.randint(0, n, e))
        elif kind == "gaps":  # in-degree 0 at the start, middle and end
            e = 20 * n
            col = rng.choice(np.r_[3:n // 2 - 2, n // 2 + 3:n - 4], e)
        else:  # "sparse": N > E, most targets without edges
            e = n // 3
            col = rng.randint(0, n, e)
        graphs.append(np.stack([rng.randint(0, n, e), col]))
    return torch.from_numpy(np.stack(graphs).astype(np.int64))


def _graph_inputs(kind, b, n, h, d, device, seed, big=False):
    """Operands over a ``_graph`` (with the source-major CSR the backward
    walks); ``big``: LayerNorm scale and shift that put pre-activations out
    to about +-100."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa
    ei = _graph(kind, b, n, rng).to(device)
    e = ei.shape[-1]
    return (t(rng.randn(b, n, h)), t(rng.randn(b, n, h)),
            t(rng.randn(b, e, d)), t(rng.randn(d, h) * 0.3),
            t((40.0 if big else 1.0) + 0.1 * rng.randn(h)),
            t((30.0 if big else 0.1) * rng.randn(h)),
            target_csr(ei, n, sources=True))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kind,b,n,h,d,big", [
    ("hub", 1, 200, 256, 5, False),   # the hub crosses warps and blocks
    ("hub", 3, 50, 96, 8, False),
    ("hub", 24, 200, 256, 5, False),
    ("gaps", 1, 200, 32, 1, False),
    ("gaps", 3, 64, 256, 5, True),
    ("sparse", 1, 300, 96, 5, False),
    ("sparse", 24, 90, 32, 8, False),
])
def test_kernel_with_uneven_in_degrees(cuda, training, kind, b, n, h, d,
                                       big):
    args = _graph_inputs(kind, b, n, h, d, cuda, seed=n + h + d, big=big)
    sd, p = (_seed(cuda, 99), 0.1) if training else (None, 0.0)
    got = fused_edge_layer(*args, sd, dropout_p=p, deterministic=not training)
    want = fused_edge_layer_reference(*args, sd, p)
    torch.testing.assert_close(got, want, **TOL)
    assert bool((got[want == 0] == 0).all())
    assert torch.equal(got, fused_edge_layer(*args, sd, dropout_p=p,
                                             deterministic=not training))


def test_kernel_on_edges_shared_by_the_batch(cuda):
    """Training hands over one (2, E) edge index expanded over the batch:
    its target row has stride 0."""
    b, n, k, h = 3, 40, 6, 64
    rng = np.random.RandomState(6)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa
    pos = t(rng.rand(n, 3) * 10 - 5)
    edges = target_csr(knn_edge_index(pos, k).expand(b, -1, -1), n)
    assert edges.col.stride(0) == 0
    args = (t(rng.randn(b, n, h)), t(rng.randn(b, n, h)),
            t(rng.randn(b, n * k, 5)), t(rng.randn(5, h) * 0.3),
            t(1 + 0.1 * rng.randn(h)), t(0.1 * rng.randn(h)), edges)
    for sd, p in ((None, 0.0), (_seed(cuda, 8), 0.1)):
        torch.testing.assert_close(
            fused_edge_layer(*args, sd, dropout_p=p, deterministic=sd is None),
            fused_edge_layer_reference(*args, sd, p), **TOL)


def test_kernel_pre_activations_out_to_100(cuda):
    """The fast SiLU (one exp, one approximate reciprocal) at |y| ~ 100."""
    args = _graph_inputs("gaps", 2, 40, 256, 5, cuda, seed=4, big=True)
    tp, sp, ea, we, gamma, beta, edges = args
    from nbody_gnn_hpc_torch.ops.fused_edge import _stream
    _, y, _, _ = _stream(tp, sp, ea, we, gamma, beta, edges)
    assert y.abs().max().item() > 100.0
    for sd, p in ((None, 0.0), (_seed(cuda, 5), 0.1)):
        torch.testing.assert_close(
            fused_edge_layer(*args, sd, dropout_p=p, deterministic=sd is None),
            fused_edge_layer_reference(*args, sd, p), **TOL)


# Kernel 2 walks both CSRs in equal runs of edges, whatever their nodes: the
# same uneven graphs (random sources: the source CSR is no identity), in
# training form (dropout, no d_edge_attr) and the rollout fine-tune's form
# (no dropout, with d_edge_attr).

def _backward_held(args, g_out, form):
    """Kernel 2 against its plain version in ``form``, rows of nodes
    without edges exactly zero, a rerun bit for bit."""
    sd, p = (_seed(g_out.device, 31), 0.1) if form == "training" else (None,
                                                                       0.0)
    d_ea = form == "fine-tune"
    got = fused_edge_backward(*args, g_out, sd, p, need_d_edge_attr=d_ea)
    want = fused_edge_backward_reference(*args, g_out, sd, p)
    assert (got[2] is None) == (not d_ea)
    names = [i for i in range(6) if d_ea or i != 2]
    for i in names:
        scale = want[i].abs().max().item() + 1e-6
        err = (got[i] - want[i]).abs().max().item()
        assert err <= GRAD_RTOL * scale, (NAMES[i], err, scale)
    edges = args[6]
    d_tp, d_sp = (g if g.dim() == 3 else g[None] for g in got[:2])
    no_in = edges.offsets[:, 1:] == edges.offsets[:, :-1]
    no_out = edges.sources.offsets[:, 1:] == edges.sources.offsets[:, :-1]
    assert not d_tp[no_in].any() and not d_sp[no_out].any()
    again = fused_edge_backward(*args, g_out, sd, p, need_d_edge_attr=d_ea)
    for i in names:
        assert torch.equal(got[i], again[i]), NAMES[i]
    return no_in, no_out


@pytest.mark.parametrize("form", ["training", "fine-tune"])
@pytest.mark.parametrize("kind,b,n,h,d", [
    ("hub", 1, 200, 256, 5),   # the hub crosses warps and blocks
    ("hub", 3, 50, 96, 8),
    ("hub", 24, 200, 256, 5),
    ("gaps", 1, 200, 32, 1),
    ("gaps", 3, 64, 256, 5),
    ("sparse", 1, 300, 96, 5),
    ("sparse", 24, 90, 32, 8),
])
def test_backward_with_uneven_degrees(cuda, form, kind, b, n, h, d):
    args = _graph_inputs(kind, b, n, h, d, cuda, seed=2 * n + h + d)
    g_out = torch.randn(args[0].shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(b))
    no_in, no_out = _backward_held(args, g_out, form)
    if kind == "sparse":  # most nodes have no edges on either side
        assert no_in.any() and no_out.any()


def test_backward_on_edges_shared_by_the_batch(cuda):
    """Training hands over one (2, E) edge index expanded over the batch:
    the target and source rows have stride 0."""
    b, n, k, h = 3, 40, 6, 64
    rng = np.random.RandomState(7)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa
    pos = t(rng.rand(n, 3) * 10 - 5)
    edges = target_csr(knn_edge_index(pos, k).expand(b, -1, -1), n,
                       sources=True)
    assert edges.col.stride(0) == 0 and edges.row.stride(0) == 0
    args = (t(rng.randn(b, n, h)), t(rng.randn(b, n, h)),
            t(rng.randn(b, n * k, 5)), t(rng.randn(5, h) * 0.3),
            t(1 + 0.1 * rng.randn(h)), t(0.1 * rng.randn(h)), edges)
    g_out = t(rng.randn(b, n, h))
    for form in ("training", "fine-tune"):
        _backward_held(args, g_out, form)


def test_graphs_without_edges(cuda):
    """No edges: both kernels give zeros (and an empty d_edge_attr)."""
    b, n, h = 2, 10, 64
    rng = np.random.RandomState(8)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa
    edges = target_csr(torch.zeros((b, 2, 0), dtype=torch.int64,
                                   device=cuda), n, sources=True)
    args = (t(rng.randn(b, n, h)), t(rng.randn(b, n, h)),
            t(rng.randn(b, 0, 5)), t(rng.randn(5, h)),
            t(1 + 0.1 * rng.randn(h)), t(0.1 * rng.randn(h)), edges)
    for sd, p in ((None, 0.0), (_seed(cuda, 9), 0.1)):
        out = fused_edge_layer(*args, sd, dropout_p=p,
                               deterministic=sd is None)
        assert out.shape == (b, n, h) and not out.any()
        grads = fused_edge_backward(*args, t(rng.randn(b, n, h)), sd, p)
        assert grads[2].shape == (b, 0, 5)
        for name, g in zip(NAMES, grads):
            assert not g.any(), name


def test_backward_pre_activations_out_to_100(cuda):
    """silu' from the fast sigmoid (one exp, one approximate reciprocal) at
    |y| ~ 100, in both forms."""
    args = _graph_inputs("gaps", 2, 40, 256, 5, cuda, seed=4, big=True)
    from nbody_gnn_hpc_torch.ops.fused_edge import _stream
    _, y, _, _ = _stream(*args)
    assert y.min().item() < -100.0 and y.max().item() > 100.0
    g_out = torch.randn(args[0].shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(3))
    for form in ("training", "fine-tune"):
        _backward_held(args, g_out, form)


# -- direct-force kernels (csrc/pairwise.cu) --------------------------------

# As the JAX package's kernel tests (tests/test_ops.py): float32 sum order
# and rsqrt rounding only, relative to the force scale.
FORCE_RTOL, FORCE_ATOL_OF_SCALE = 2e-4, 1e-5


def _system(n, device, seed=0, batch=None):
    rng = np.random.RandomState(seed)
    shape = (n,) if batch is None else (batch, n)
    pos = (rng.rand(*shape, 3) - 0.5) * 10.0
    m = rng.uniform(1e10, 1e12, shape)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa
    return t(pos), t(m)


def _assert_forces_close(got, want):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=FORCE_RTOL,
                               atol=FORCE_ATOL_OF_SCALE * scale)


def _force_kernels():
    from nbody_gnn_hpc_torch import ops

    return {"tiled": (ops.accelerations_tiled,
                      ops.accelerations_tiled_reference),
            "small": (ops.accelerations_small,
                      ops.accelerations_small_reference),
            "symmetric": (ops.accelerations_symmetric,
                          ops.accelerations_symmetric_reference)}


# Beyond the main paths' shapes, the edges of the schedules
# (ops.small_schedule, ops.sym_schedule): kernel 4 at generate_data's
# default batch, a large B with a ragged and with the largest N, two
# blocks an SM of an odd count of warps (B=256, N=926); kernel 6
# at tiny N, the dispatch's least N and one below and one above a multiple
# of each tile it takes on an H100 (32, 64, 128 particles); kernel 3
# (ops.tiled_schedule on an H100's 132 SMs) at tiny N, a last tile one short
# (2,047, 9,727) and of one source (4,097, 9,729), one above a multiple of k
# (2,049), ragged receiver groups (2,111, 4,097, 9,727, 9,729), k split
# into 2 and 4 slices (2,049 to 4,097), N=10,000, and blocks that stage two
# and four systems (B=3 at N=2,085, B=300 at N=200).
@pytest.mark.parametrize("name,n,batch", [
    ("tiled", 700, None), ("tiled", 2085, None), ("tiled", 128, None),
    ("tiled", 200, 5), ("symmetric", 700, None), ("symmetric", 2085, None),
    ("symmetric", 128, None), ("symmetric", 5, None), ("small", 200, 300),
    ("small", 200, None), ("small", 13, 3), ("small", 1024, 2),
    ("small", 200, 100), ("small", 13, 2000), ("small", 1024, 200),
    ("small", 926, 256),
    ("symmetric", 1, None), ("symmetric", 3, None),
    ("symmetric", 2048, None), ("symmetric", 2079, None),
    ("symmetric", 2081, None), ("symmetric", 4159, None),
    ("symmetric", 4161, None), ("symmetric", 9983, None),
    ("symmetric", 9985, None),
    ("tiled", 1, None), ("tiled", 3, None), ("tiled", 2047, None),
    ("tiled", 2049, None), ("tiled", 2111, None), ("tiled", 4097, None),
    ("tiled", 9727, None), ("tiled", 9729, None), ("tiled", 10000, None),
    ("tiled", 2085, 3), ("tiled", 200, 300)])
def test_force_kernel_matches_plain_version(cuda, name, n, batch):
    kernel, plain = _force_kernels()[name]
    pos, m = _system(n, cuda, seed=n, batch=batch)
    before = kernel.launches
    got = kernel(pos, m)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == pos.shape
    _assert_forces_close(got, plain(pos, m))
    assert torch.equal(got, kernel(pos, m))  # fixed sum order


def test_force_kernels_agree_and_conserve_momentum(cuda):
    from nbody_gnn_hpc_torch import ops

    pos, m = _system(3000, cuda, seed=7)
    sym = ops.accelerations_symmetric(pos, m)
    _assert_forces_close(sym, ops.accelerations_tiled(pos, m))
    for acc in (sym, ops.accelerations_tiled(pos, m)):
        f = m[:, None].double() * acc.double()
        assert f.sum(0).abs().max() <= 1e-5 * f.abs().sum(0).max()


@pytest.mark.parametrize("name", ["tiled", "small", "symmetric"])
def test_force_kernel_edge_cases(cuda, name):
    """A coincident heavy pair stays finite (G*m/eps^3 overflows float32)
    and zero-mass particles are force-neutral."""
    kernel, _ = _force_kernels()[name]
    pos = torch.tensor([[0.0, 0, 0], [0.0, 0, 0], [1.0, 0, 0]], device=cuda)
    m = torch.tensor([2e30, 2e30, 1.0], device=cuda)
    acc = kernel(pos, m)
    assert torch.isfinite(acc).all()
    assert acc[0, 0] > 0 and acc[2, 0] < 0
    pos, m = _system(300, cuda, seed=3)
    base = kernel(pos, m)
    extra = torch.cat([pos, pos.new_full((45, 3), 2.5)])
    padded = kernel(extra, torch.cat([m, m.new_zeros(45)]))
    scale = base.abs().max().item()
    torch.testing.assert_close(padded[:300], base, rtol=0, atol=2e-5 * scale)


def test_force_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from nbody_gnn_hpc_torch import ops

    pos, m = _system(40, cuda)
    with pytest.raises(TypeError):
        ops.accelerations_tiled(pos.double(), m.double())
    with pytest.raises(ValueError):
        ops.accelerations_symmetric(pos[None], m[None])
    with pytest.raises(ValueError):
        ops.accelerations_small(*_system(1025, cuda))
    with pytest.raises(ValueError):
        ops.accelerations_tiled(pos, m.cpu())


def test_large_n_dispatch_runs_the_symmetric_kernel(cuda):
    from nbody_gnn_hpc_torch import ops
    from nbody_gnn_hpc_torch.sim import accelerations, blocked_accelerations

    pos, m = _system(2085, cuda, seed=11)
    before = ops.accelerations_symmetric.launches
    got = accelerations(pos, m)
    assert ops.accelerations_symmetric.launches == before + 1
    _assert_forces_close(got, blocked_accelerations(pos, m))
    both = accelerations(torch.stack([pos, pos]), torch.stack([m, m]))
    assert ops.accelerations_symmetric.launches == before + 3
    assert torch.equal(both[1], got)


# -- the whole-layer kernel (csrc/fused_edge_full.cu) -----------------------

# Forward against the plain version, relative to the output's scale: six
# float32 products of depth 256-512 and two LayerNorms in another summation
# order.  Gradients relative to each gradient's scale.
FULL_RTOL_OF_SCALE, FULL_GRAD_RTOL = 1e-4, 1e-3


def _full_inputs(b, n, k, h, device, seed=0, ho=None):
    from nbody_gnn_hpc_torch.ops import edge_features

    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa
    ho = ho or h
    s = 1 / np.sqrt(h)
    pos = t(rng.rand(b, n, 3) * 10 - 5)
    ei = knn_edge_index(pos, k)
    p = dict(wt=t(rng.randn(h, h) * s), bt=t(rng.randn(h) * .1),
             ws=t(rng.randn(h, h) * s), we=t(rng.randn(h, 5) * .3),
             ge=t(1 + .1 * rng.randn(h)), be=t(.1 * rng.randn(h)),
             wout=t(rng.randn(h, h) * s), bout=t(rng.randn(h) * .1),
             w1=t(rng.randn(h, 2 * h) * s), b1=t(rng.randn(h) * .1),
             g1=t(1 + .1 * rng.randn(h)), be1=t(.1 * rng.randn(h)),
             w2=t(rng.randn(ho, h) * s), b2=t(rng.randn(ho) * .1))
    mask = t((rng.rand(b, n, h) >= .1) / .9)
    return (t(rng.randn(b, n, h)), edge_features(pos, ei), p,
            target_csr(ei, n, sources=True), mask)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("b,n,k,h,ho", [
    (1, 200, 40, 256, None), (8, 200, 40, 256, None),
    (24, 200, 40, 256, None), (1, 13, 4, 256, None), (2, 37, 5, 32, None),
    (3, 50, 7, 96, 64),
    # the 16-row tile's edges, and a batch whose items outnumber the
    # persistent grid in every phase
    (2, 15, 6, 256, None), (2, 16, 6, 256, None), (2, 17, 6, 96, 64),
    (64, 200, 40, 256, None)])
def test_whole_layer_kernel_matches_plain_version(cuda, b, n, k, h, ho,
                                                  training):
    from nbody_gnn_hpc_torch.ops import (fused_full_layer,
                                         fused_full_layer_reference)

    hh, ea, p, edges, mask = _full_inputs(b, n, k, h, cuda, seed=n + h,
                                          ho=ho)
    seed, mask, rate = (_seed(cuda), mask, 0.1) if training else (None, None,
                                                                  0.0)
    with torch.inference_mode():
        before = fused_full_layer.launches
        got = fused_full_layer(hh, ea, p, edges, seed, mask, dropout_p=rate,
                               deterministic=not training)
        torch.cuda.synchronize()
        assert fused_full_layer.launches == before + 1  # cooperative
        want, _ = fused_full_layer_reference(hh, ea, p, edges, seed, mask,
                                             rate)
        assert got.shape == (b, n, ho or h)
        err = (got - want).abs().max().item()
        assert err <= FULL_RTOL_OF_SCALE * want.abs().max().item()
        assert torch.equal(got, fused_full_layer(
            hh, ea, p, edges, seed, mask, dropout_p=rate,
            deterministic=not training))  # fixed summation order


def test_whole_layer_two_launch_form_equals_cooperative(cuda, monkeypatch):
    from nbody_gnn_hpc_torch.ops import fused_edge_full as ff

    hh, ea, p, edges, mask = _full_inputs(8, 200, 40, 256, cuda, seed=4)
    for seed, node_mask, rate in ((None, None, 0.0), (_seed(cuda), mask, 0.1)):
        with torch.inference_mode():
            monkeypatch.setattr(ff, "COOPERATIVE", True)
            one = ff.fused_full_layer(hh, ea, p, edges, seed, node_mask,
                                      dropout_p=rate, deterministic=not rate)
            monkeypatch.setattr(ff, "COOPERATIVE", False)
            before = ff.fused_full_layer.launches
            phased = ff.fused_full_layer(hh, ea, p, edges, seed, node_mask,
                                         dropout_p=rate,
                                         deterministic=not rate)
            assert ff.fused_full_layer.launches == before + ff.PHASES
        assert torch.equal(one, phased)
    for alone in range(1, ff.PHASES + 1):  # the timing hook: one launch
        monkeypatch.setattr(ff, "PHASE_ALONE", alone)
        before = ff.fused_full_layer.launches
        with torch.inference_mode():
            ff.fused_full_layer(hh, ea, p, edges)
        assert ff.fused_full_layer.launches == before + 1


def test_whole_layer_takes_views_that_start_off_16_bytes(cuda):
    """The kernel stages h and the weights with 16-byte copies; views that
    start one float into their storage give the same bits."""
    from nbody_gnn_hpc_torch.ops import fused_full_layer

    hh, ea, p, edges, _ = _full_inputs(2, 37, 5, 96, cuda, seed=7)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    with torch.inference_mode():
        want = fused_full_layer(hh, ea, p, edges)
        got = fused_full_layer(shifted(hh), ea,
                               {k: shifted(v) for k, v in p.items()}, edges)
    assert torch.equal(got, want)


def test_whole_layer_gradients_match_plain_composition(cuda):
    from nbody_gnn_hpc_torch.ops import (fused_full_layer,
                                         fused_full_layer_plain)
    from nbody_gnn_hpc_torch.ops.fused_edge_full import PARAM_KEYS

    hh, ea, p, edges, mask = _full_inputs(4, 200, 40, 256, cuda, seed=3)
    g_out = torch.randn_like(hh)

    def grads(fn):
        leaves = [hh.clone().requires_grad_(), ea.clone().requires_grad_()]
        params = {k: v.clone().requires_grad_() for k, v in p.items()}
        out = fn(leaves[0], leaves[1], params, edges, _seed(cuda), mask,
                 dropout_p=0.1, deterministic=False)
        assert out.grad_fn is not None
        out.backward(g_out)
        return [t.grad for t in leaves + [params[k] for k in PARAM_KEYS]]

    before = fused_edge_backward.launches
    got = grads(fused_full_layer)
    assert fused_edge_backward.launches == before + 1  # kernel 2
    for name, g, w in zip(("h", "edge_attr") + PARAM_KEYS, got,
                          grads(fused_full_layer_plain)):
        err = (g - w).abs().max().item()
        assert err <= FULL_GRAD_RTOL * (w.abs().max().item() + 1e-6), name


def test_whole_layer_model_equals_fused_model(cuda):
    """``edge_impl="fused_full"`` against ``"fused"`` on one state dict:
    kernel 7 six times and kernel 1 never, the same output."""
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.ops import fused_full_layer

    kw = dict(hidden_dim=256, n_layers=6)
    fused = NBodyGNN(generator=torch.Generator().manual_seed(0), **kw)
    with torch.no_grad():
        fused.decoder_out.weight.normal_(
            0, 0.05, generator=torch.Generator().manual_seed(1))
    full = NBodyGNN(edge_impl="fused_full", **kw)
    full.load_state_dict(fused.state_dict())
    fused, full = fused.to(cuda).eval(), full.to(cuda).eval()
    x = torch.randn(8, 200, 7, device=cuda)
    ei = knn_edge_index(x[..., :3], 40)
    with torch.inference_mode():
        want = fused(x, ei)
        k7, k1 = fused_full_layer.launches, fused_edge_layer.launches
        got = full(x, ei)
    assert fused_full_layer.launches == k7 + 6
    assert fused_edge_layer.launches == k1
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item()


# The rollout fine-tune's unrolled loss (train/rollout_tune.py): its
# gradient crosses K chained steps and enters each step's edge features
# (kernel 2's d_edge_attr; with fused_full, kernel 7's backward).  Against
# the plain versions on the same weights and windows: float32 sum order,
# amplified through the chain and the LayerNorms, as the model's one-step
# gradients (chip_smoke.py MODEL_GRAD_RTOL).
UNROLL_GRAD_RTOL = 1e-3


def _unroll_problem(cuda, edge_impl, b=4, n=64, k=8, horizon=4, h=64):
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.train import make_unroll_loss

    model = NBodyGNN(hidden_dim=h, n_layers=3, dropout=0.0,
                     edge_impl=edge_impl,
                     generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.decoder_out.weight.normal_(
            0, 0.05, generator=torch.Generator().manual_seed(1))
    model = model.to(cuda)
    rng = np.random.RandomState(2)
    seq = np.concatenate([3 * rng.randn(b, horizon + 1, n, 3),
                          rng.randn(b, horizon + 1, n, 3)], -1)
    norm = {"state_mean": np.zeros(6, np.float32),
            "state_std": np.full(6, 1.5, np.float32)}
    masses = rng.uniform(1, 2, n).astype(np.float32)
    loss_fn = make_unroll_loss(model, norm, (masses / masses.mean())[:, None],
                               k, n, horizon)
    return model, loss_fn, torch.from_numpy(seq.astype(np.float32)).to(cuda)


def _unroll_grads(model, loss_fn, seq, plain):
    from nbody_gnn_hpc_torch.ops import (fused_edge_layer_plain,
                                         fused_full_layer,
                                         fused_full_layer_plain)

    for layer in model.layers:
        layer.edge_stream, layer.full_layer = (
            (fused_edge_layer_plain, fused_full_layer_plain) if plain
            else (fused_edge_layer, fused_full_layer))
    model.zero_grad(set_to_none=True)
    loss = loss_fn(seq)
    loss.backward()
    return loss.item(), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("edge_impl", ["fused", "fused_full"])
def test_unroll_gradients_match_plain_path(cuda, edge_impl):
    from nbody_gnn_hpc_torch.ops import fused_full_layer

    model, loss_fn, seq = _unroll_problem(cuda, edge_impl)
    fwd = fused_full_layer if edge_impl == "fused_full" else fused_edge_layer
    before = fwd.launches, fused_edge_backward.launches
    loss, got = _unroll_grads(model, loss_fn, seq, plain=False)
    # 3 layers x 4 steps, forward and kernel 2 in the backward
    assert (fwd.launches - before[0],
            fused_edge_backward.launches - before[1]) == (12, 12)
    want_loss, want = _unroll_grads(model, loss_fn, seq, plain=True)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        assert scale > 0  # every parameter gets a gradient
        assert (g - w).abs().max().item() <= UNROLL_GRAD_RTOL * scale


@pytest.mark.parametrize("edge_impl", ["fused", "fused_full"])
def test_unroll_kernel_path_reruns_are_bit_identical(cuda, edge_impl):
    """The kernels are deterministic; PyTorch's own scatter (the gather
    backward of the edge features) is made so for the comparison."""
    model, loss_fn, seq = _unroll_problem(cuda, edge_impl)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        first = _unroll_grads(model, loss_fn, seq, plain=False)
        second = _unroll_grads(model, loss_fn, seq, plain=False)
    finally:
        torch.use_deterministic_algorithms(False)
    assert first[0] == second[0]
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))


def test_whole_layer_wrapper_rejects_bad_operands(cuda):
    from nbody_gnn_hpc_torch.ops import fused_full_layer

    hh, ea, p, edges, _ = _full_inputs(1, 20, 4, 64, cuda, seed=5)
    with pytest.raises(TypeError):
        fused_full_layer(hh.double(), ea, p, edges)
    with pytest.raises(ValueError, match="shape"):
        fused_full_layer(hh, ea, dict(p, w1=p["w1"][:, :64].contiguous()),
                         edges)
    with pytest.raises(ValueError, match="multiple of 32"):
        bad = _full_inputs(1, 20, 4, 48, cuda, seed=6)
        fused_full_layer(*bad[:4])


# -- kernel 7's bf16 form (csrc/fused_edge_full_bf16.cu) ----------------------
#
# Against its plain bf16 version: both round where the TPU kernel rounds
# (t, s, each stream term, z1, h_new), and a float32 sum-order difference
# (the kernel's fast exp and divide too) that moves a value across a
# rounding boundary moves it by one bf16 step.  h_new is rounded twice,
# bf16(bf16(a W2^T) + bf16(b2)): where the product lies in a binade above
# h_new's, a step of the first rounding is two of h_new's, so the largest
# error may reach BF16_FULL_MAX_OF_SCALE.  And one step in t, s, a stream
# term or z1 moves every channel of its row of h_new a little (each output
# reads the whole row of a), so more elements lie beyond 1e-4 of scale
# than in kernels 1 and 2: 0.8-1.0 % at N=200 and 2.7-3.4 % at N=13, where
# a row is 7.7 % of the elements, measured on an H100; at most
# BF16_FULL_SHARE.  The float32 kernel on the same bf16 weights rounds
# nothing: 93-95 % of its elements lie beyond, and the rule must refuse
# it.  Gradients against the reference backward: within BF16_MAX_OF_SCALE
# of each one's scale (a bf16 step of its largest element; d_wt and d_ws
# are bf16), measured up to 5.2e-3; float32 sums over a batch of bf16
# terms put up to half of a gradient's elements beyond 1e-4 of scale, so
# no share is held there.
BF16_FULL_MAX_OF_SCALE, BF16_FULL_SHARE = 2.0 ** -6, 0.2

# SHA-256 of kernel 7's float32 h_new and summed (the bytes of both, in that
# order) at fixed inputs, computed on an H100 (132 SMs) with the float32
# kernel as it was before the bf16 form was added: the float32
# instantiation of the templated kernel must reproduce them bit for bit.
# The schedule is a function of the shape and the SM count, so they hold
# on a 132-SM card only.
FULL_F32_DIGESTS = {
    "8-200-40-inference":
        "f7b975f594ac0c2cc3262c8ebaba651139d2a5f10ae1b24ba074188a261c9687",
    "24-200-40-training":
        "d20eeefc053853da6609c3dc36dd4e5fcc512b95d192184a89849b2d60421763",
    "1-13-4-training":
        "2bfe7e84626b97c78b07ecfe8d966dcafcde83085768d2facba6ae087cf12cce"}
FULL_F32_DIGEST_SMS = 132


def _bf16_full(p):
    return dict(p, wt=p["wt"].bfloat16(), ws=p["ws"].bfloat16())


def _full_case(b, n, k, training, cuda, seed, h=256, ho=None):
    hh, ea, p, edges, mask = _full_inputs(b, n, k, h, cuda, seed=seed, ho=ho)
    seed, mask, rate = ((_seed(cuda), mask, 0.1) if training
                        else (None, None, 0.0))
    return hh, ea, p, edges, seed, mask, rate


# The bf16 form's shapes: B=1, 8 and 24 at N=200 (200 and 1,600 rows are
# not multiples of its 64-row tiles), 13 rows (not a multiple of 16), and
# H=96 with Ho=64 at 4,800 rows (P1's 64-wide tiles straddle t and s, and
# its last 64-channel chunk is half full).
BF16_FULL_SHAPES = [(1, 200, 40, 256, None), (8, 200, 40, 256, None),
                    (24, 200, 40, 256, None), (1, 13, 4, 256, None),
                    (48, 100, 8, 96, 64)]


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("b,n,k,h,ho", BF16_FULL_SHAPES)
def test_whole_layer_bf16_kernel_matches_plain_version(cuda, b, n, k, h, ho,
                                                       training):
    """Kernel 7's bf16 form (wt and ws bf16; its products on the bf16
    tensor cores) at the shapes of BF16_FULL_SHAPES: within BF16_FULL_MAX_OF_SCALE and
    BF16_FULL_SHARE of its plain bf16 version, one bf16 launch and no
    float32 one, reruns bit-identical; the float32 kernel on the same bf16
    weights is refused by that rule."""
    from nbody_gnn_hpc_torch.ops import (fused_full_layer,
                                         fused_full_layer_reference)

    hh, ea, p, edges, seed, mask, rate = _full_case(
        b, n, k, training, cuda, seed=n + b, h=h, ho=ho)
    p16 = _bf16_full(p)
    kw = dict(dropout_p=rate, deterministic=not training)
    with torch.inference_mode():
        before = (fused_full_layer.launches, fused_full_layer.bf16_launches)
        got = fused_full_layer(hh, ea, p16, edges, seed, mask, **kw)
        torch.cuda.synchronize()
        assert (fused_full_layer.launches, fused_full_layer.bf16_launches) \
            == (before[0], before[1] + 1)
        want, _ = fused_full_layer_reference(hh, ea, p16, edges, seed, mask,
                                             rate)
        assert got.dtype == torch.float32 and got.shape == (b, n, ho or h)
        _assert_bf16_close(got, want, "h_new", BF16_FULL_MAX_OF_SCALE,
                           BF16_FULL_SHARE)
        assert torch.equal(got, fused_full_layer(hh, ea, p16, edges, seed,
                                                 mask, **kw))
        control = fused_full_layer(
            hh, ea, dict(p, wt=p16["wt"].float(), ws=p16["ws"].float()),
            edges, seed, mask, **kw)
    with pytest.raises(AssertionError):
        _assert_bf16_close(control, want, "control",
                           BF16_FULL_MAX_OF_SCALE, BF16_FULL_SHARE)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("b,n,k,h,ho", BF16_FULL_SHAPES)
def test_whole_layer_bf16_ordinary_launch_form_equals_cooperative(
        cuda, monkeypatch, b, n, k, h, ho, training):
    """The bf16 form's six ordinary launches give the cooperative launch's
    bits (h_new and summed), in both forms of the layer, at every shape of
    BF16_FULL_SHAPES."""
    from nbody_gnn_hpc_torch.ops import fused_edge_full as ff

    hh, ea, p, edges, seed, mask, rate = _full_case(
        b, n, k, training, cuda, seed=b + n, h=h, ho=ho)
    p16 = _bf16_full(p)
    with torch.inference_mode():
        monkeypatch.setattr(ff, "COOPERATIVE", True)
        one = ff._launch(hh, ea, p16, edges, seed, mask, rate)
        monkeypatch.setattr(ff, "COOPERATIVE", False)
        before = ff.fused_full_layer.bf16_launches
        phased = ff._launch(hh, ea, p16, edges, seed, mask, rate)
        assert ff.fused_full_layer.bf16_launches == before + ff.PHASES
    assert all(torch.equal(x, y) for x, y in zip(one, phased)), \
        (b, n, training)


def test_whole_layer_bf16_wrapper_passes_wt_ws_in_bf16(cuda, monkeypatch):
    """The bf16 form hands the caller's bf16 wt and ws to the kernel as
    they are (their own storage: no float32 copy is made), in one bf16
    launch."""
    from nbody_gnn_hpc_torch.ops import cuda_build
    from nbody_gnn_hpc_torch.ops import fused_edge_full as ff

    calls = []

    class Spy:
        def __init__(self, fn):
            object.__setattr__(self, "fn", fn)

        def __setattr__(self, key, value):  # argtypes, restype
            setattr(self.fn, key, value)

        def __call__(self, *args):
            calls.append(args)
            return self.fn(*args)

    class Lib:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return Spy(getattr(self.lib, name))

    real = cuda_build.load_library
    monkeypatch.setattr(cuda_build, "load_library",
                        lambda name: Lib(real(name)))
    hh, ea, p, edges, seed, mask, rate = _full_case(24, 200, 40, True, cuda,
                                                    seed=24)
    p16 = _bf16_full(p)
    with torch.inference_mode():
        before = ff.fused_full_layer.bf16_launches
        ff.fused_full_layer(hh, ea, p16, edges, seed, mask, dropout_p=rate,
                            deterministic=False)
        torch.cuda.synchronize()
    assert ff.fused_full_layer.bf16_launches == before + 1
    (args,) = calls
    keys = ff.PARAM_KEYS
    assert args[5 + keys.index("wt")] == p16["wt"].data_ptr()
    assert args[5 + keys.index("ws")] == p16["ws"].data_ptr()


def _full_digest(out, summed) -> str:
    import hashlib

    return hashlib.sha256(out.cpu().numpy().tobytes()
                          + summed.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("case", ["8-200-40-inference", "24-200-40-training",
                                  "1-13-4-training"])
def test_whole_layer_float32_form_is_unchanged(cuda, monkeypatch, case):
    """The float32 instantiation gives, in both launch forms, the bits of
    the float32 kernel before the bf16 form was added (FULL_F32_DIGESTS)."""
    from nbody_gnn_hpc_torch.device import sm_count
    from nbody_gnn_hpc_torch.ops import fused_edge_full as ff

    if sm_count(cuda.index or 0) != FULL_F32_DIGEST_SMS:
        pytest.skip(f"the saved bits are of a {FULL_F32_DIGEST_SMS}-SM card")
    b, n, k, form = case.split("-")
    hh, ea, p, edges, seed, mask, rate = _full_case(
        int(b), int(n), int(k), form == "training", cuda,
        seed=int(n) + int(b))
    for cooperative in (True, False):
        monkeypatch.setattr(ff, "COOPERATIVE", cooperative)
        with torch.inference_mode():
            out, summed = ff._launch(hh, ea, p, edges, seed, mask, rate)
        assert _full_digest(out, summed) == FULL_F32_DIGESTS[case], \
            cooperative


def test_whole_layer_bf16_backward_matches_reference_backward(cuda):
    """The bf16 form's custom backward (kernel 2's bf16 form inside) at
    B=24 in training form against the reference backward on the card
    (the plain forward's summed, kernel 2's plain bf16 version): every
    gradient within BF16_MAX_OF_SCALE of its scale; d_wt and d_ws bf16 and
    bf16-exact, the other gradients float32; one bf16 launch of kernels 7
    and 2 each."""
    from nbody_gnn_hpc_torch.ops import (fused_full_layer,
                                         fused_full_layer_backward_reference)
    from nbody_gnn_hpc_torch.ops.fused_edge_full import PARAM_KEYS

    hh, ea, p, edges, seed, mask, _ = _full_case(24, 200, 40, True, cuda,
                                                 seed=24)
    p16 = _bf16_full(p)
    g_out = torch.randn(hh.shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(24))
    leaves = [hh.clone().requires_grad_(), ea.clone().requires_grad_()]
    params = {key: t.clone().requires_grad_() for key, t in p16.items()}
    before = (fused_full_layer.bf16_launches, fused_edge_backward.launches,
              fused_edge_backward.bf16_launches)
    out = fused_full_layer(leaves[0], leaves[1], params, edges, seed, mask,
                           dropout_p=0.1, deterministic=False)
    out.backward(g_out)
    torch.cuda.synchronize()
    assert (fused_full_layer.bf16_launches, fused_edge_backward.launches,
            fused_edge_backward.bf16_launches) == (before[0] + 1, before[1],
                                                   before[2] + 1)
    got = [t.grad for t in leaves + [params[key] for key in PARAM_KEYS]]
    want = fused_full_layer_backward_reference(hh, ea, p16, edges, g_out,
                                               seed, mask, 0.1)
    for name, g, w in zip(("h", "edge_attr") + PARAM_KEYS, got, want):
        assert g.dtype == w.dtype == (torch.bfloat16 if name in ("wt", "ws")
                                      else torch.float32), name
        if name in ("wt", "ws"):
            assert torch.equal(g.float().bfloat16().float(), g.float())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BF16_MAX_OF_SCALE * (w.float().abs().max().item()
                                           + 1e-6), name


def test_bf16_whole_layer_model_runs_kernel7_bf16_form(cuda):
    """A bf16 NBodyGNN with edge_impl="fused_full" at the production width:
    a training step launches kernel 7's bf16 form and kernel 2's bf16 form
    six times each and no float32 form of either, nor kernel 1; its loss
    is within 1e-3 relative of the same step through the plain versions
    (``fused_full_layer_plain``, same seeds and masks)."""
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.ops import fused_full_layer_plain, launch_counts

    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(4, 200, 7).astype(np.float32)).to(cuda)
    ei = knn_edge_index(x[..., :3], 40)
    losses = []
    for plain in (False, True):
        model = NBodyGNN(hidden_dim=256, n_layers=6, dtype=torch.bfloat16,
                         edge_impl="fused_full",
                         generator=torch.Generator().manual_seed(0)).to(cuda)
        with torch.no_grad():
            model.decoder_out.weight.fill_(0.01)
        if plain:
            for layer in model.layers:
                layer.full_layer = fused_full_layer_plain
        counts = launch_counts()
        gen = torch.Generator(cuda).manual_seed(3)
        loss = model.train()(x, ei, generator=gen).square().mean()
        loss.backward()
        torch.cuda.synchronize()
        moved = {key: v - counts[key] for key, v in launch_counts().items()
                 if v != counts[key]}
        assert moved == ({} if plain else {"fused_full_fwd_bf16": 6,
                                           "fused_edge_bwd_bf16": 6})
        assert all(q.grad.dtype == torch.float32 and q.grad.abs().max() > 0
                   for q in model.parameters())
        losses.append(loss.item())
    assert abs(losses[0] - losses[1]) <= 1e-3 * abs(losses[1])


def test_int8_on_cuda_tensors_equals_numpy(cuda):
    """Quantizing on the card gives the file's numbers: ``q`` and ``scale``
    bit for bit (CUDA divides by a Python scalar as a product with its
    reciprocal, so the scale is divided by a tensor)."""
    from nbody_gnn_hpc_torch.predict.quantize import (quantize_params,
                                                      tree_to_device)

    rng = np.random.RandomState(7)
    tree = {"dense": {"kernel": rng.randn(256, 512).astype(np.float32),
                      "bias": rng.randn(512).astype(np.float32)}}
    on_card = quantize_params(
        {"dense": {k: torch.from_numpy(v).to(cuda)
                   for k, v in tree["dense"].items()}}, "int8")
    from_host = tree_to_device(quantize_params(tree, "int8"), cuda)
    for key in ("q", "scale"):
        assert torch.equal(on_card["dense"]["kernel"][key],
                           from_host["dense"]["kernel"][key]), key


# -- kernel 5, the tensor-core moment force (csrc/pairwise.cu) ---------------

# The JAX package's test of the moment form (tests/test_ops.py:162-178):
# float32 sum order and rsqrt rounding, amplified by the centring
# cancellation for the closest pairs.
MXU_RTOL, MXU_ATOL_OF_SCALE = 2e-4, 2e-5


# The last six are edges of the kernel's schedule (ops.mma_schedule on an
# H100): tiles of 32 (1, 2, 127, 129), one above a multiple of 64 near
# N=2,085 (2,049) and one below a multiple of 128 near N=10,000 (9,983).
@pytest.mark.parametrize("n,offset", [(700, 300.0), (2085, 0.0), (128, 0.0),
                                      (5, 0.0), (1, 0.0), (2, 0.0),
                                      (127, 0.0), (129, 0.0), (2049, 0.0),
                                      (9983, 0.0)])
def test_moment_force_kernel_matches_plain_version(cuda, n, offset):
    from nbody_gnn_hpc_torch import ops

    pos, m = _system(n, cuda, seed=n)
    pos = pos + offset
    before = ops.accelerations_symmetric_mxu.launches
    got = ops.accelerations_symmetric_mxu(pos, m)
    torch.cuda.synchronize()
    assert ops.accelerations_symmetric_mxu.launches == before + 1
    assert got.shape == (n, 3)
    want = ops.accelerations_symmetric_mxu_reference(pos, m)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=MXU_RTOL,
                               atol=MXU_ATOL_OF_SCALE * scale)
    assert torch.equal(got, ops.accelerations_symmetric_mxu(pos, m))
    assert ops.accelerations_symmetric_mxu.launches == before + 2


# The moment form's rounding bound: each pair's two terms, s_ij W_j[1:4]
# and x_i s_ij W_j[0] (x centred), come out of the 3xTF32 products and the
# float32 sums within ~2^-21 of themselves, so a_i lies within
# 2^-20 sum_j s_ij G m_j (|x_i| + |x_j|) of its exact value.  It grows with
# the closest pairs' |x| / |d|, which the fixed tolerance above does not:
# on this file's systems at 2,047, 2,111, 2,113, 9,985 and 10,000 the
# float32 plain version is itself farther than that tolerance from the
# float64 value (the test prints its share), so no float32 implementation
# of the form can be held to it there.
MXU_ROUNDING = 2.0 ** -20


def _moment_rounding_bound(pos, m, rows=1000):
    """Per particle, ``MXU_ROUNDING`` sum_j s_ij G m_j (|x_i| + |x_j|) in
    float64 on the card, positions centred."""
    from nbody_gnn_hpc_torch.device import G, SOFTENING

    p = pos.double() - pos.double().mean(0)
    gm, r = G * m.double(), p.norm(dim=1)
    out = torch.empty(len(p), dtype=torch.float64, device=pos.device)
    for i0 in range(0, len(p), rows):
        d = p[None] - p[i0:i0 + rows, None]
        d2 = (d * d).sum(-1)
        s = torch.where(d2 > 0, (d2 + SOFTENING ** 2) ** -1.5,
                        torch.zeros_like(d2))
        out[i0:i0 + rows] = (s * gm * (r[None] + r[i0:i0 + rows, None])).sum(1)
    return MXU_ROUNDING * out


@pytest.mark.parametrize("n", [1, 2, 127, 129, 2047, 2049, 2111, 2113, 9983,
                               9985, 10000])
def test_moment_force_kernel_at_its_schedule_edges(cuda, n):
    """The edges of the kernel's schedule (ops.mma_schedule on an H100):
    tiny systems (tiles of 32), one below and one above a multiple of the
    tile it takes near N=2,085 (64) and N=10,000 (128), and N=10,000:
    finite, within the moment form's rounding bound of its plain version
    evaluated in float64, rerun bit-identical, one count on ``launches``
    a call.  Prints (``pytest -rP``) the largest share of the bound and of
    the fixed tolerance above that the kernel and its float32 plain
    version take."""
    from nbody_gnn_hpc_torch import ops

    pos, m = _system(n, cuda, seed=n)
    before = ops.accelerations_symmetric_mxu.launches
    got = ops.accelerations_symmetric_mxu(pos, m)
    torch.cuda.synchronize()
    assert ops.accelerations_symmetric_mxu.launches == before + 1
    assert got.shape == (n, 3) and bool(torch.isfinite(got).all())
    exact = ops.accelerations_symmetric_mxu_reference(pos.double(), m.double())
    plain = ops.accelerations_symmetric_mxu_reference(pos, m).double()
    k64 = got.double()
    err = (k64 - exact).abs()
    bound = _moment_rounding_bound(pos, m)[:, None]

    def share(a, b, tol=None):  # the largest |a - b| / tol
        if tol is None:  # the fixed tolerance, relative to b
            tol = MXU_ATOL_OF_SCALE * b.abs().max() + MXU_RTOL * b.abs()
        return ((a - b).abs() / tol).nan_to_num().max().item()

    print(f"N={n}: of the rounding bound, kernel "
          f"{share(k64, exact, bound):.3f}, float32 plain version "
          f"{share(plain, exact, bound):.3f}; of rtol {MXU_RTOL:g} / atol "
          f"{MXU_ATOL_OF_SCALE:g} of scale, kernel vs plain "
          f"{share(k64, plain):.3f}, plain vs float64 "
          f"{share(plain, exact):.3f}, kernel vs float64 "
          f"{share(k64, exact):.3f}")
    assert bool((err <= bound).all()), (err / bound).nan_to_num().max().item()
    assert torch.equal(got, ops.accelerations_symmetric_mxu(pos, m))
    assert ops.accelerations_symmetric_mxu.launches == before + 2


def test_moment_force_kernel_is_dispatched_by_nothing(cuda):
    from nbody_gnn_hpc_torch import ops
    from nbody_gnn_hpc_torch.sim import accelerations

    pos, m = _system(2085, cuda, seed=3)
    before = ops.accelerations_symmetric_mxu.launches
    accelerations(pos, m)
    accelerations(*_system(200, cuda, seed=4))
    assert ops.accelerations_symmetric_mxu.launches == before


def test_moment_force_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from nbody_gnn_hpc_torch import ops

    pos, m = _system(40, cuda)
    with pytest.raises(TypeError):
        ops.accelerations_symmetric_mxu(pos.double(), m.double())
    with pytest.raises(ValueError):
        ops.accelerations_symmetric_mxu(pos, m.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        ops.accelerations_symmetric_mxu(pos.t().contiguous().t(), m)
    with pytest.raises(ValueError):
        ops.accelerations_symmetric_mxu(pos[None], m[None])


# -- kernels 10 and 11, the rate probes (csrc/probes.cu) ---------------------

# The plain FMA rounds each step once, as __fmaf_rn does (its multiply and
# add are taken in float64); rsqrtf is approximate, and the rsqrt recurrence
# contracts (by 1/2 a step near its fixed point), so that gap does not grow.
PROBE_RTOL = 1e-5


def _probe_input(shape, device, seed=3):
    x = np.random.RandomState(seed).uniform(0.5, 1.5, shape)
    return torch.from_numpy(x.astype(np.float32)).to(device)


@pytest.mark.parametrize("form", ["kernel", "chain", "chain4"])
@pytest.mark.parametrize("probe", ["fma", "rsqrt"])
def test_probe_kernel_matches_plain_version(cuda, probe, form):
    from nbody_gnn_hpc_torch import ops

    kernel = ops.fma_probe if probe == "fma" else ops.rsqrt_probe
    plain = (ops.fma_probe_reference if probe == "fma"
             else ops.rsqrt_probe_reference)
    kw = {"kernel": {},
          "chain": dict(start=(0.0,), add=1e-4),
          "chain4": dict(start=(0.0, 1.0, 2.0, 3.0), add=1e-4)}[form]
    if probe == "fma" and form != "kernel":
        kw["mul"] = (0.9999,) * len(kw["start"])
    shape, steps = ((256, 1024), 1024) if form == "kernel" else ((64, 512),
                                                                 256)
    x = _probe_input(shape, cuda)
    before = kernel.launches
    got = kernel(x, steps, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(got, plain(x, steps, **kw), rtol=PROBE_RTOL,
                               atol=0)
    assert torch.equal(got, kernel(x, steps, **kw))


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from nbody_gnn_hpc_torch import ops

    x = _probe_input((64, 128), cuda)
    for probe in (ops.fma_probe, ops.rsqrt_probe):
        with pytest.raises(TypeError):
            probe(x.double(), 4)
        with pytest.raises(ValueError, match="contiguous"):
            probe(x.t(), 4)
        with pytest.raises(ValueError, match="cuda or cpu"):
            probe(x.to("meta"), 4)
        with pytest.raises(ValueError, match="accumulators"):
            probe(x, 4, start=(0.0, 1.0))


# -- data parallel: the graph offset of the edge dropout, and world one ------

DROPOUT_P = 0.1

@pytest.mark.parametrize("split", [1, 5])
def test_graph_offset_on_the_card(cuda, split):
    """Kernels 1, 2 and 7 on the rows [split, 6) of a batch, counted from
    ``split``, give the plain versions' results for those rows of the whole
    batch: the same dropout masks (any other mask would move every output
    far past the tolerance)."""
    from nbody_gnn_hpc_torch.ops import (fused_full_layer,
                                         fused_full_layer_reference)

    b, n, k, h = 6, 200, 40, 256
    tp, sp, ea, we, gamma, beta, edges = _inputs(b, n, k, h, cuda, seed=21)
    seed = _seed(cuda)
    ei = torch.stack([edges.row, edges.col], 1)
    part = target_csr(ei[split:], n, sources=True, graph0=split)
    args = (tp, sp, ea, we, gamma, beta)
    with torch.inference_mode():
        want = fused_edge_layer_reference(*args, edges, seed, DROPOUT_P)
        got = fused_edge_layer(*(a[split:] if a.dim() == 3 else a
                                 for a in args), part, seed,
                               dropout_p=DROPOUT_P, deterministic=False)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want[split:], **TOL)
        g_out = torch.randn(b, n, h, device=cuda,
                            generator=torch.Generator(cuda).manual_seed(2))
        want_g = fused_edge_backward_reference(*args, edges, g_out, seed,
                                               DROPOUT_P)
        got_g = fused_edge_backward(*(a[split:] if a.dim() == 3 else a
                                      for a in args), part, g_out[split:],
                                    seed, DROPOUT_P)
        torch.cuda.synchronize()
        _assert_grads_close(got_g[:3], [w[split:] for w in want_g[:3]])

        hh, ea7, p, edges7, mask = _full_inputs(b, n, k, h, cuda, seed=22)
        ei7 = torch.stack([edges7.row, edges7.col], 1)
        part7 = target_csr(ei7[split:], n, graph0=split)
        want7, _ = fused_full_layer_reference(hh, ea7, p, edges7, seed, mask,
                                              DROPOUT_P)
        got7 = fused_full_layer(hh[split:], ea7[split:], p, part7, seed,
                                mask[split:], dropout_p=DROPOUT_P,
                                deterministic=False)
        torch.cuda.synchronize()
        err = (got7 - want7[split:]).abs().max().item()
        assert err <= FULL_RTOL_OF_SCALE * want7.abs().max().item()


def test_dp_step_at_world_one_equals_the_single_device_step(cuda):
    """NCCL at world one: the ``gspmd`` DP step (noise and dropout on)
    equals ``make_train_step`` on the same card, to 1e-6 of each tensor's
    scale, and launches kernels 1 and 2 once a layer and step each."""
    import torch.distributed as dist

    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.parallel import (init_data_parallel,
                                              make_dp_train_step, make_mesh)
    from nbody_gnn_hpc_torch.train import make_optimizer, make_train_step

    created = not dist.is_initialized()
    init_data_parallel("cuda")
    try:
        rng = np.random.RandomState(5)
        n, k, bsz = 60, 8, 4
        pos = torch.from_numpy(rng.rand(n, 3).astype(np.float32) * 10)
        ei = knn_edge_index(pos, k)
        masses = torch.from_numpy(rng.uniform(1e10, 1e12, n).astype(
            np.float32)).to(cuda)
        states = torch.from_numpy(rng.randn(bsz, n, 6).astype(
            np.float32)).to(cuda)
        targets = states + 0.01

        def run(mesh):
            model = NBodyGNN(hidden_dim=64, n_layers=2, dropout=0.1,
                             generator=torch.Generator().manual_seed(0))
            model = model.to(cuda)
            args = (model, make_optimizer(model, 5e-4, 1e-4), ei,
                    torch.zeros(6), torch.ones(6),
                    (masses / masses.mean())[:, None])
            kw = dict(noise_std=0.003, masses=masses)
            step = (make_train_step(*args, **kw) if mesh is None else
                    make_dp_train_step(*args, mesh=mesh, **kw))
            gen = torch.Generator(cuda).manual_seed(9)
            before = fused_edge_layer.launches, fused_edge_backward.launches
            losses = [step(states, targets, gen).item() for _ in range(2)]
            launched = (fused_edge_layer.launches - before[0],
                        fused_edge_backward.launches - before[1])
            return losses, list(model.parameters()), launched

        want, want_p, _ = run(None)
        got, got_p, launched = run(make_mesh())
        assert launched == (4, 4)  # 2 layers x 2 steps
        np.testing.assert_allclose(got, want, rtol=1e-6)
        for g, w in zip(got_p, want_p):
            err = (g - w).abs().max().item()
            assert err <= 1e-6 * (w.abs().max().item() + 1e-12)
    finally:
        if created:
            dist.destroy_process_group()


@pytest.mark.parametrize("command,argv,kernels", [
    ("benchmark_bh_temp", ["-n", "2085", "--steps", "1"],
     {"pairwise_symmetric": 1 + 1 + 50 + 50}),
    ("examples.demo_serving", [], {"fused_edge_fwd": None}),
])
def test_commands_launch_their_kernels(cuda, command, argv, kernels):
    """The large-N benchmark at N=2,085 (kernel 6 once a force evaluation:
    the initial one, the warm-up step, the untimed round and one round) and
    the serving demo at its defaults (kernel 1 on every rollout step), each
    a process on the card, reading the launch line it prints last."""
    import subprocess
    import sys
    from pathlib import Path

    from nbody_gnn_hpc_torch.ops import LAUNCH_LINE, read_launch_line

    proc = subprocess.run(
        [sys.executable, "-m", f"nbody_gnn_hpc_torch.{command}", *argv],
        cwd=Path(__file__).resolve().parent.parent, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert proc.stdout.splitlines()[-1].startswith(LAUNCH_LINE)
    counts = read_launch_line(proc.stdout)
    for name, want in kernels.items():
        assert counts[name] > 0 if want is None else counts[name] == want, \
            (name, counts)
    assert counts["pairwise_symmetric_mxu"] == 0
