"""The port's CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (``nvcc``); without a
card they skip.  They import no JAX, so on a machine without it run them
as ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.ops import (fused_edge_layer,
                                     fused_edge_layer_reference,
                                     knn_edge_index, target_csr)

pytestmark = pytest.mark.gpu

# float32 on both sides; the kernel and scatter_add_ sum the ~k messages of
# a target in different orders (reduction order only).
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(b, n, k, h, device, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa
    pos = t(rng.rand(b, n, 3) * 10 - 5)
    edges = target_csr(knn_edge_index(pos, k), n)
    return (t(rng.randn(b, n, h)), t(rng.randn(b, n, h)),
            t(rng.randn(b, n * k, 5)), t(rng.randn(5, h) * 0.3),
            t(1 + 0.1 * rng.randn(h)), t(0.1 * rng.randn(h)), edges)


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


def test_kernel_reruns_are_bit_identical(cuda):
    args = _inputs(8, 200, 40, 256, cuda, seed=1)
    first = fused_edge_layer(*args)
    second = fused_edge_layer(*args)
    assert torch.equal(first, second)


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
