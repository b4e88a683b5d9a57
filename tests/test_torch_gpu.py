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
