"""The port's direct-force functions (nbody_gnn_hpc_torch/ops/pairwise.py)
against the JAX package's Pallas kernels run in interpret mode.

On the CPU each wrapper takes its kernel's plain version, which repeats the
CUDA kernel's arithmetic in torch ops; the kernels themselves are held
against these plain versions on the card (tests/test_torch_gpu.py).
Tolerances as tests/test_ops.py: float32 sum order and rsqrt rounding,
rtol 2e-4 with atol 1e-5 of the force scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch import ops
from nbody_gnn_hpc_torch.sim import pairwise_accelerations
from nbody_gnn_hpc_tpu.ops import (pallas_accelerations,
                                   pallas_accelerations_small,
                                   pallas_accelerations_symmetric)
from nbody_gnn_hpc_tpu.ops.pairwise import pallas_accelerations_symmetric_mxu

KERNELS = {
    "tiled": (ops.accelerations_tiled, ops.accelerations_tiled_reference,
              pallas_accelerations),
    "symmetric": (ops.accelerations_symmetric,
                  ops.accelerations_symmetric_reference,
                  pallas_accelerations_symmetric),
    "small": (ops.accelerations_small, ops.accelerations_small_reference,
              pallas_accelerations_small),
}


def _system(n, seed, batch=None):
    rng = np.random.RandomState(seed)
    shape = (n,) if batch is None else (batch, n)
    pos = ((rng.rand(*shape, 3) - 0.5) * 10.0).astype(np.float32)
    m = rng.uniform(1e10, 1e12, shape).astype(np.float32)
    return pos, m


def _close(got, want, rtol=2e-4, atol_of_scale=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_of_scale * np.abs(want).max())


@pytest.mark.parametrize("name,n", [("tiled", 700), ("symmetric", 700),
                                    ("small", 200)])
def test_plain_version_matches_pallas_kernel(name, n):
    wrapper, plain, pallas = KERNELS[name]
    pos, m = _system(n, seed=n)
    want = pallas(jnp.asarray(pos), jnp.asarray(m), interpret=True)
    t_pos, t_m = torch.from_numpy(pos), torch.from_numpy(m)
    got = wrapper(t_pos, t_m)  # a CPU tensor takes the plain version
    assert got.shape == (n, 3) and got.dtype == torch.float32
    assert torch.equal(got, plain(t_pos, t_m))
    _close(got, want)
    _close(got, pairwise_accelerations(t_pos, t_m))
    assert wrapper.launches == 0  # counts kernel launches only


def test_small_ensemble_matches_vmapped_pallas_kernel():
    pos, m = _system(40, seed=1, batch=3)
    want = jax.vmap(lambda p, mm: pallas_accelerations_small(
        p, mm, interpret=True))(jnp.asarray(pos), jnp.asarray(m))
    got = ops.accelerations_small(torch.from_numpy(pos), torch.from_numpy(m))
    assert got.shape == (3, 40, 3)
    _close(got, want)
    for i in range(3):
        torch.testing.assert_close(got[i], ops.accelerations_small(
            torch.from_numpy(pos[i]), torch.from_numpy(m[i])))


def test_tiled_ensemble_equals_per_system():
    pos, m = _system(150, seed=2, batch=2)
    got = ops.accelerations_tiled(torch.from_numpy(pos), torch.from_numpy(m))
    for i in range(2):
        torch.testing.assert_close(got[i], ops.accelerations_tiled(
            torch.from_numpy(pos[i]), torch.from_numpy(m[i])))


@pytest.mark.parametrize("name,n", [("tiled", 512), ("symmetric", 300),
                                    ("small", 200)])
def test_momentum_neutral(name, n):
    """sum_i m_i a_i = 0 to float32 rounding (tests/test_ops.py:25-58);
    n spans several tiles, so the symmetric form's cross-tile reaction is
    in the sum."""
    pos, m = _system(n, seed=3)
    acc = KERNELS[name][0](torch.from_numpy(pos), torch.from_numpy(m))
    f = m.astype(np.float64)[:, None] * acc.numpy().astype(np.float64)
    assert np.abs(f.sum(0)).max() < 1e-5 * np.abs(f).sum()


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_coincident_heavy_pair_stays_finite(name):
    """G*m/eps^3 overflows float32 at solar masses; the d2 > 0 select keeps
    inf * 0 out of the sums."""
    pos = torch.tensor([[0.0, 0, 0], [0.0, 0, 0], [1.0, 0, 0]])
    m = torch.tensor([2e30, 2e30, 1.0])
    acc = KERNELS[name][0](pos, m)
    assert torch.isfinite(acc).all()
    assert acc[0, 0] > 0 and acc[2, 0] < 0
    torch.testing.assert_close(acc, pairwise_accelerations(pos, m))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_zero_mass_particles_are_force_neutral(name):
    pos, m = _system(300, seed=4)
    fn = KERNELS[name][0]
    base = fn(torch.from_numpy(pos), torch.from_numpy(m))
    extra = np.concatenate([pos, np.full((45, 3), 2.5, np.float32)])
    padded = fn(torch.from_numpy(extra),
                torch.from_numpy(np.concatenate([m, np.zeros(45, np.float32)])))
    # float32 sum order only: the zero terms regroup the tiles' sums
    _close(padded[:300], base, rtol=0, atol_of_scale=2e-5)


def test_symmetric_tile_size_only_reorders_the_sum():
    pos, m = _system(333, seed=5)
    t_pos, t_m = torch.from_numpy(pos), torch.from_numpy(m)
    want = pairwise_accelerations(t_pos, t_m)
    for tile in (32, 128, 512):
        _close(ops.accelerations_symmetric_reference(t_pos, t_m, tile=tile),
               want, rtol=0, atol_of_scale=2e-5)
        _close(ops.accelerations_tiled_reference(t_pos, t_m, tile=tile),
               want, rtol=0, atol_of_scale=2e-5)


def test_small_refuses_large_systems():
    pos, m = _system(ops.SMALL_MAX_N + 1, seed=6)
    with pytest.raises(ValueError, match="N <="):
        ops.accelerations_small(torch.from_numpy(pos), torch.from_numpy(m))


def test_cuda_operand_checks_raise_before_any_launch():
    """What the wrappers refuse on a device tensor (checked on the meta
    device: no card here); nothing falls back to the plain version."""
    pos = torch.empty(40, 3, device="meta")
    m = torch.empty(40, device="meta")
    for fn in (ops.accelerations_tiled, ops.accelerations_small,
               ops.accelerations_symmetric):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(pos, m)
        assert fn.launches == 0


def _mxu_case(case):
    """The three systems of tests/test_ops.py:162-202."""
    rng = np.random.RandomState({"offset_cloud": 700, "momentum": 1024,
                                 "solar": 512}[case])
    if case == "offset_cloud":
        pos = (rng.rand(700, 3) - 0.5) * 10.0 + 300.0
        m = rng.uniform(1e10, 1e12, 700)
    elif case == "momentum":
        pos = (rng.rand(1024, 3) - 0.5) * 10.0
        m = rng.uniform(1e10, 1e12, 1024)
    else:
        pos = np.concatenate([[[0, 0, 0], [1.496e11, 0, 0]],
                              rng.rand(510, 3) * 1e11])
        m = np.concatenate([[1.989e30, 5.97e24], rng.uniform(1e20, 1e22, 510)])
    return pos.astype(np.float32), m.astype(np.float32)


@pytest.mark.parametrize("case", ["offset_cloud", "momentum", "solar"])
def test_moment_form_matches_pallas_mxu_kernel(case):
    """Kernel 5's plain version (the CPU path of
    ``accelerations_symmetric_mxu``) against ``pallas_accelerations_symmetric_mxu``
    in interpret mode, as tests/test_ops.py:162-202 holds the Pallas kernel,
    in every case to rtol 2e-4, atol 2e-5 of scale (the centring
    cancellation; the largest gap measured 0.57 of that tolerance, in the
    momentum case): an offset cloud at a non-tile-multiple N, momentum
    neutrality across tiles (under 5e-5, the moment form's measured 2.7e-5
    there) and solar masses (finite: the self pair is zeroed in the
    s-plane)."""
    pos, m = _mxu_case(case)
    t_pos, t_m = torch.from_numpy(pos), torch.from_numpy(m)
    got = ops.accelerations_symmetric_mxu(t_pos, t_m)
    assert got.shape == pos.shape and got.dtype == torch.float32
    assert torch.equal(got, ops.accelerations_symmetric_mxu_reference(t_pos,
                                                                      t_m))
    want = np.asarray(pallas_accelerations_symmetric_mxu(
        jnp.asarray(pos), jnp.asarray(m), interpret=True))
    assert np.isfinite(got.numpy()).all() and np.isfinite(want).all()
    _close(got, want, atol_of_scale=2e-5)
    if case == "offset_cloud":
        _close(got, pairwise_accelerations(t_pos, t_m), atol_of_scale=2e-5)
    elif case == "momentum":
        for acc in (got.numpy(), want):
            f = m.astype(np.float64)[:, None] * acc.astype(np.float64)
            assert np.abs(f.sum(0)).max() < 5e-5 * np.abs(f).sum()
    assert ops.accelerations_symmetric_mxu.launches == 0


def test_moment_form_tile_size_only_reorders_the_sum():
    pos, m = _system(333, seed=8)
    t_pos, t_m = torch.from_numpy(pos), torch.from_numpy(m)
    want = pairwise_accelerations(t_pos, t_m)
    for tile in (32, 128, 512):
        _close(ops.accelerations_symmetric_mxu_reference(t_pos, t_m,
                                                         tile=tile),
               want, atol_of_scale=2e-5)


def test_moment_form_wrapper_refuses_other_devices():
    pos = torch.empty(40, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.accelerations_symmetric_mxu(pos, torch.empty(40, device="meta"))
    assert ops.accelerations_symmetric_mxu.launches == 0
