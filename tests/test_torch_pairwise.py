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


# -- the launch schedules of kernels 4 and 6 ---------------------------------
# The kernels cannot run here; these tests repeat their index arithmetic
# (csrc/pairwise.cu: pairwise_small_kernel, nbody_pairwise_small,
# tile_pair) on the schedules the wrappers pass, and check that every pair
# is covered exactly once and every scratch cell has exactly one writer.


def _small_lanes(b, n, r, k, threads):
    """Per lane of kernel 4's grid: (live, system, first receiver, part),
    and per block the systems it stages (first, count)."""
    groups = -(-n // r)
    total = b * groups
    per_block = threads // k
    blocks = -(-total // per_block)
    lane = np.arange(blocks * threads)
    first = lane // threads * per_block
    mine = first + lane % threads // k
    g = np.minimum(mine, total - 1)
    sys = g // groups
    i0 = (g - sys * groups) * r
    block_first = np.arange(blocks) * per_block
    last = np.minimum(block_first + per_block, total) - 1
    sys0 = block_first // groups
    staged = (sys0, last // groups - sys0 + 1)
    return mine < total, sys, i0, lane % threads % k, staged


@pytest.mark.parametrize("sm_count", [132, 8])
@pytest.mark.parametrize("b,n", [(300, 200), (100, 200), (1, 200), (3, 13),
                                 (2000, 13), (2000, 1024), (1, 1), (7, 3),
                                 (65, 1000), (33, 517), (5, 64),
                                 (256, 926), (255, 795), (256, 862)])
def test_small_schedule_covers_every_pair_once(b, n, sm_count):
    """Every (system, receiver) is written by exactly one lane group, the
    k lanes of a group split the sources into a partition of range(N), and
    every block's staged systems hold its groups' and fit shared memory."""
    r, k, threads = ops.small_schedule(b, n, sm_count)
    assert r in (1, 2) and k in (1, 2, 4, 8)
    assert threads % 32 == 0 and 32 <= threads <= 1024 and threads % k == 0
    live, sys, i0, part, (sys0, span) = _small_lanes(b, n, r, k, threads)
    written = np.zeros((b, n), np.int64)
    for q in range(r):
        keep = live & (part == 0) & (i0 + q < n)
        np.add.at(written, (sys[keep], i0[keep] + q), 1)
    assert (written == 1).all()
    sources = np.zeros(n, np.int64)
    for p in range(k):  # lane p: j = p + k t for t < n // k, then a tail j
        js = list(range(p, p + k * (n // k), k))
        js += [p + k * (n // k)] if p + k * (n // k) < n else []
        np.add.at(sources, js, 1)
    assert (sources == 1).all()
    block = np.arange(len(live)) // threads
    assert ((sys >= sys0[block]) & (sys < sys0[block] + span[block])).all()
    staged = ops.pairwise.small_staged(b, n, r, k, threads)
    assert span.max() <= staged
    assert staged * n * 16 <= ops.pairwise.SMALL_SMEM


def test_small_schedule_fills_the_card_at_the_datagen_shapes():
    """One block an SM at most, and as many warps as the rule asks."""
    for b, want in ((300, (2, 4, 928)), (100, (2, 8, 608)),
                    (1, (1, 8, 128))):
        r, k, threads = ops.small_schedule(b, 200, 132)
        assert (r, k, threads) == want
        assert -(-b * -(-200 // r) // (threads // k)) <= 132


def _tile_pairs(tiles):
    """Kernel 6's item -> (I, J) decode (tile_pair) for every item."""
    q = np.arange(tiles * (tiles + 1) // 2, dtype=np.int64)
    d = 2.0 * tiles + 1.0
    i = ((d - np.sqrt(d * d - 8.0 * q)) * 0.5).astype(np.int64)
    start = lambda r: r * tiles - r * (r - 1) // 2  # noqa: E731
    for _ in range(3):  # the kernel's correction loops, run to a fixed point
        i = np.where((i > 0) & (start(i) > q), i - 1, i)
        i = np.where((i + 1 < tiles) & (start(i + 1) <= q), i + 1, i)
    return i, i + q - start(i)


@pytest.mark.parametrize("sm_count", [132, 8])
@pytest.mark.parametrize("n", [1, 2, 3, 31, 32, 33, 100, 1000, 2047, 2048,
                               2049, 2079, 2081, 2085, 4096, 4097, 4159,
                               4161, 8192, 8193, 9983, 9985, 10000, 12000])
def test_symmetric_schedule_covers_every_pair_once(n, sm_count):
    """The triangle of tile pairs is launched whole and once (so every
    unordered particle pair falls in exactly one item), and every (slot,
    row tile) cell of the scratch has exactly one writer."""
    rows = ops.sym_schedule(n, sm_count)
    assert rows in (1, 2, 4)
    tiles = -(-n // (32 * rows))
    ti, tj = _tile_pairs(tiles)
    assert (ti <= tj).all() and (tj < tiles).all()
    pairs = np.zeros((tiles, tiles), np.int64)
    np.add.at(pairs, (ti, tj), 1)
    assert (pairs == np.triu(np.ones_like(pairs))).all()
    writers = np.zeros((tiles, tiles), np.int64)  # [slot, row tile]
    np.add.at(writers, (tj, ti), 1)               # i side: slot J, rows of I
    off = ti != tj
    np.add.at(writers, (ti[off], tj[off]), 1)     # j side: slot I, rows of J
    assert (writers == 1).all()
    if n <= 2100:  # particle pairs, where the count stays small
        tile_of = np.arange(n) // (32 * rows)
        lo, hi = np.minimum.outer(tile_of, tile_of), np.maximum.outer(
            tile_of, tile_of)
        assert (pairs[lo, hi] == 1).all()


def test_symmetric_schedule_at_the_simulate_shapes():
    assert ops.sym_schedule(10_000, 132) == 4  # 3,160 pairs of 128-tiles
    assert ops.sym_schedule(2_085, 132) == 1   # 2,211 pairs of 32-tiles
    assert ops.sym_schedule(5_000, 132) == 2
    assert ops.sym_schedule(10_000, 8) == 4
