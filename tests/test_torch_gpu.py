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
# of each tile it takes on an H100 (32, 64, 128 particles).
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
    ("symmetric", 9985, None)])
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


@pytest.mark.parametrize("n,offset", [(700, 300.0), (2085, 0.0), (128, 0.0),
                                      (5, 0.0)])
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
