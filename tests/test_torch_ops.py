"""Port graph ops (nbody_gnn_hpc_torch/ops) against the JAX package's.

Inputs come from a seeded numpy RNG and go through both frameworks as numpy
arrays.  The fused edge stream's plain forward and backward are held
against the JAX Pallas kernels in interpret mode (the JAX package's own CPU
route): ``_fwd_kernel`` / ``_bwd_kernel`` and their batch-folded twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.ops import (dropout_keep, edge_features,
                                     edge_index_for,
                                     fully_connected_edge_index,
                                     fused_edge_backward_reference,
                                     fused_edge_layer,
                                     fused_edge_layer_reference,
                                     is_row_regular, knn_edge_index,
                                     target_csr)
from nbody_gnn_hpc_torch.ops.fused_edge import (BWD_MIN_RUN, FWD_MIN_RUN,
                                                MAX_CHUNK, MAX_RUN, WARPS,
                                                _arrivals, bwd_schedule,
                                                fwd_schedule, philox4x32)
from nbody_gnn_hpc_tpu.models.gnn import target_adjacency
from nbody_gnn_hpc_tpu.ops import edges as jedges
from nbody_gnn_hpc_tpu.ops import knn as jknn
from nbody_gnn_hpc_tpu.ops.fused_edge import \
    fused_edge_layer as jfused_edge_layer
from nbody_gnn_hpc_tpu.ops.fused_edge_batched import \
    fused_edge_layer_batched as jfused_edge_layer_batched

# float32 on both sides; the only differences are summation orders (norms,
# LayerNorm means, the k-term target sums), a few ulps of values O(1-10).
TOL = dict(rtol=1e-5, atol=1e-5)


def _knn_sets(edge_index, n, k):
    return np.sort(np.asarray(edge_index)[1].reshape(n, k), axis=1)


def test_edge_features_match_jax():
    rng = np.random.RandomState(0)
    pos = rng.randn(16, 3).astype(np.float32)
    ei = np.asarray(jknn.knn_edge_index(jnp.asarray(pos), 4))
    want = np.asarray(jedges.edge_features(jnp.asarray(pos), jnp.asarray(ei)))
    got = edge_features(torch.from_numpy(pos), torch.tensor(ei).long())
    assert got.shape == (64, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_edge_features_batched_equals_per_graph():
    rng = np.random.RandomState(1)
    pos = torch.from_numpy(rng.randn(3, 12, 3).astype(np.float32))
    ei = knn_edge_index(pos, 3)
    got = edge_features(pos, ei)
    for b in range(3):
        torch.testing.assert_close(got[b], edge_features(pos[b], ei[b]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n,k,block", [(16, 4, None), (37, 5, None),
                                       (37, 5, 8), (64, 6, 64), (50, 7, 16)])
def test_knn_edge_sets_match_jax(n, k, block):
    """Same neighbour set per row as lax.top_k (dense and row-blocked);
    the order inside a row may differ on ties."""
    pos = np.random.RandomState(n + k).randn(n, 3).astype(np.float32)
    want = jknn.knn_edge_index(jnp.asarray(pos), k, block_size=block)
    got = knn_edge_index(torch.from_numpy(pos), k, block_size=block)
    assert got.shape == (2, n * k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want)[0])
    np.testing.assert_array_equal(_knn_sets(got, n, k),
                                  _knn_sets(want, n, k))
    assert not np.any(got[0].numpy() == got[1].numpy())  # no self edges


def test_knn_batched_and_blocked_equal_per_graph_dense():
    pos = torch.from_numpy(
        np.random.RandomState(2).randn(4, 30, 3).astype(np.float32))
    batched = knn_edge_index(pos, 5)
    blocked = knn_edge_index(pos, 5, block_size=7)
    assert batched.shape == (4, 2, 150)
    for b in range(4):
        torch.testing.assert_close(batched[b], knn_edge_index(pos[b], 5))
    torch.testing.assert_close(blocked, batched)


def test_fully_connected_and_row_regular():
    np.testing.assert_array_equal(fully_connected_edge_index(7),
                                  jknn.fully_connected_edge_index(7))
    fc = edge_index_for(7, None, device="cpu")
    assert fc.shape == (2, 42) and is_row_regular(fc, 7)
    pos = torch.randn(9, 3, generator=torch.Generator().manual_seed(0))
    knn = edge_index_for(9, 3, positions=pos)
    assert is_row_regular(knn, 9)
    assert is_row_regular(knn_edge_index(pos[None].expand(2, -1, -1), 3), 9)
    assert not is_row_regular(knn.flip(0), 9)
    assert not is_row_regular(knn[:, :-1], 9)


def test_target_csr_layout():
    pos = torch.from_numpy(
        np.random.RandomState(3).randn(2, 13, 3).astype(np.float32))
    ei = knn_edge_index(pos, 4)
    csr = target_csr(ei, 13)
    assert csr.perm.dtype == csr.src.dtype == csr.offsets.dtype == torch.int32
    for b in range(2):
        col = ei[b, 1]
        perm = csr.perm[b].long()
        assert torch.all(col[perm][1:] >= col[perm][:-1])
        # stable: within one target the edge ids ascend
        for t in range(13):
            seg = perm[csr.offsets[b, t]:csr.offsets[b, t + 1]]
            assert torch.all(col[seg] == t) and torch.all(seg[1:] > seg[:-1])
        torch.testing.assert_close(csr.src[b].long(), ei[b, 0][perm])
        torch.testing.assert_close(
            csr.degree[b], torch.bincount(col, minlength=13).float())


def _stream_inputs(n, k, h, seed=0, batch=None):
    rng = np.random.RandomState(seed)
    lead = () if batch is None else (batch,)
    pos = rng.randn(*lead, n, 3).astype(np.float32)
    return dict(
        pos=pos,
        tp=rng.randn(*lead, n, h).astype(np.float32),
        sp=rng.randn(*lead, n, h).astype(np.float32),
        ea=rng.randn(*lead, n * k, 5).astype(np.float32),
        we=(rng.randn(5, h) * 0.3).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.randn(h)).astype(np.float32),
        beta=(0.1 * rng.randn(h)).astype(np.float32))


def _port_stream(d, ei):
    t = {key: torch.from_numpy(v) for key, v in d.items() if key != "pos"}
    return fused_edge_layer_reference(
        t["tp"], t["sp"], t["ea"], t["we"], t["gamma"], t["beta"],
        target_csr(ei, d["tp"].shape[-2]))


@pytest.mark.parametrize("n,k,h", [(16, 4, 32), (13, 4, 32)])
def test_fused_reference_matches_jax_kernel(n, k, h):
    """Plain version == the JAX Pallas kernel (interpret mode); N=13 is
    odd, which the JAX wrapper pads to 16 internally."""
    d = _stream_inputs(n, k, h, seed=n)
    ei = jknn.knn_edge_index(jnp.asarray(d["pos"]), k)
    adj, _ = target_adjacency(ei, n, jnp.float32)
    want = jfused_edge_layer(
        jnp.asarray(d["tp"]), jnp.asarray(d["sp"]), jnp.asarray(d["ea"]),
        jnp.asarray(d["we"]), jnp.asarray(d["gamma"]), jnp.asarray(d["beta"]),
        adj.T, jnp.zeros((1, 1), jnp.int32), k=k, interpret=True)
    got = _port_stream(d, torch.tensor(np.asarray(ei)).long())
    assert got.shape == (n, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _uneven_edges(kind, n, k):
    """(2, N*k) int32 edges with row-regular sources (as the k-NN graph)
    and targets far from regular: "hub", one target taking ~80 % of the
    edges; "gaps", targets without edges at the start, middle and end."""
    rng = np.random.RandomState(24)
    row = np.repeat(np.arange(n), k)
    if kind == "hub":
        col = np.where(rng.rand(n * k) < 0.8, 5, rng.randint(0, n, n * k))
    else:
        col = rng.choice(np.r_[2:7, 9:13], n * k)
    return np.stack([row, col]).astype(np.int32)


@pytest.mark.parametrize("kind", ["hub", "gaps"])
def test_fused_reference_matches_jax_kernel_on_uneven_in_degrees(kind):
    """Row-regular sources (as the k-NN graph) with targets far from
    regular: one target taking ~80 % of the edges, or targets without
    edges at the start, middle and end."""
    n, k, h = 16, 4, 32
    d = _stream_inputs(n, k, h, seed=23)
    ei = _uneven_edges(kind, n, k)
    adj, _ = target_adjacency(jnp.asarray(ei), n, jnp.float32)
    want = jfused_edge_layer(
        jnp.asarray(d["tp"]), jnp.asarray(d["sp"]), jnp.asarray(d["ea"]),
        jnp.asarray(d["we"]), jnp.asarray(d["gamma"]), jnp.asarray(d["beta"]),
        adj.T, jnp.zeros((1, 1), jnp.int32), k=k, interpret=True)
    got = _port_stream(d, torch.from_numpy(ei).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_reference_batched_equals_per_graph():
    n, k, h, b = 13, 4, 32, 3
    d = _stream_inputs(n, k, h, seed=5, batch=b)
    ei = knn_edge_index(torch.from_numpy(d["pos"]), k)
    got = _port_stream(d, ei)
    assert got.shape == (b, n, h)
    for i in range(b):
        one = {key: (v[i] if key not in ("we", "gamma", "beta") else v)
               for key, v in d.items()}
        torch.testing.assert_close(got[i], _port_stream(one, ei[i]),
                                   rtol=0, atol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    n, k, h = 16, 4, 32
    d = _stream_inputs(n, k, h, seed=7)
    ei = knn_edge_index(torch.from_numpy(d["pos"]), k)
    t = {key: torch.from_numpy(v) for key, v in d.items()}
    csr = target_csr(ei, n)
    before = fused_edge_layer.launches
    got = fused_edge_layer(t["tp"], t["sp"], t["ea"], t["we"], t["gamma"],
                           t["beta"], csr)
    assert fused_edge_layer.launches == before  # no kernel on the CPU
    torch.testing.assert_close(got, _port_stream(d, ei), rtol=0, atol=0)


def test_wrapper_refuses_training_mode_and_other_devices():
    n, k, h = 8, 2, 32
    d = _stream_inputs(n, k, h, seed=8)
    ei = knn_edge_index(torch.from_numpy(d["pos"]), k)
    t = {key: torch.from_numpy(v) for key, v in d.items()}
    args = (t["tp"], t["sp"], t["ea"], t["we"], t["gamma"], t["beta"],
            target_csr(ei, n))
    # Training mode needs the layer's seed, and a rate below 1.
    with pytest.raises(ValueError, match="seed"):
        fused_edge_layer(*args, dropout_p=0.1, deterministic=False)
    with pytest.raises(ValueError, match="dropout_p"):
        fused_edge_layer(*args, torch.zeros(1, dtype=torch.int32),
                         dropout_p=1.0, deterministic=False)
    meta = [a.to("meta") for a in args[:6]]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_edge_layer(*meta, args[6])


def _jax_stream_args(d, ei, n):
    adj, _ = target_adjacency(ei, n, jnp.float32)
    return ([jnp.asarray(d[key]) for key in ("tp", "sp", "ea", "we", "gamma",
                                            "beta")], adj.T)


def _port_args(d, ei):
    t = {key: torch.from_numpy(v) for key, v in d.items() if key != "pos"}
    return (t["tp"], t["sp"], t["ea"], t["we"], t["gamma"], t["beta"],
            target_csr(ei, d["tp"].shape[-2]))


# The six gradients sum k edge terms per node and E (or B*E) terms per
# parameter, in another order on each side: float32 reduction order, to
# 1e-4 of each gradient's scale.
GRAD_NAMES = ("d_t_proj", "d_s_proj", "d_edge_attr", "d_w_e", "d_gamma",
              "d_beta")


def _assert_grads(got, want, rel=1e-4):
    for name, g, w in zip(GRAD_NAMES, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * (np.abs(w).max() + 1e-6),
                                   err_msg=name)


@pytest.mark.parametrize("n,k,h", [(16, 4, 32), (13, 4, 32)])
def test_plain_backward_matches_jax_bwd_kernel(n, k, h):
    """fused_edge_backward_reference == jax.vjp of the JAX fused layer,
    which runs the Pallas _bwd_kernel in interpret mode, for all six
    cotangents (N=13 goes through the JAX wrapper's padding)."""
    d = _stream_inputs(n, k, h, seed=20 + n)
    ei = jknn.knn_edge_index(jnp.asarray(d["pos"]), k)
    jargs, adj_t = _jax_stream_args(d, ei, n)
    g_out = np.random.RandomState(n).randn(n, h).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jfused_edge_layer(
        *a, adj_t, jnp.zeros((1, 1), jnp.int32), k=k, interpret=True,
        deterministic=True), *jargs)
    want = vjp(jnp.asarray(g_out))
    got = fused_edge_backward_reference(
        *_port_args(d, torch.tensor(np.asarray(ei)).long()),
        torch.from_numpy(g_out))
    _assert_grads([g.numpy() for g in got], want)


@pytest.mark.parametrize("kind", ["hub", "gaps"])
def test_plain_backward_matches_jax_bwd_kernel_on_uneven_in_degrees(kind):
    """The six gradients of the plain backward == jax.vjp of the JAX fused
    layer (the Pallas _bwd_kernel in interpret mode) on the uneven graphs
    of the forward's test: a hub target, and targets without edges (whose
    d_t_proj rows are zero on both sides; both graphs have some)."""
    n, k, h = 16, 4, 32
    d = _stream_inputs(n, k, h, seed=25)
    ei = _uneven_edges(kind, n, k)
    jargs, adj_t = _jax_stream_args(d, jnp.asarray(ei), n)
    g_out = np.random.RandomState(26).randn(n, h).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jfused_edge_layer(
        *a, adj_t, jnp.zeros((1, 1), jnp.int32), k=k, interpret=True,
        deterministic=True), *jargs)
    want = vjp(jnp.asarray(g_out))
    got = fused_edge_backward_reference(
        *_port_args(d, torch.from_numpy(ei).long()), torch.from_numpy(g_out))
    _assert_grads([g.numpy() for g in got], want)
    no_in = np.bincount(ei[1], minlength=n) == 0
    assert no_in.any()
    assert not got[0].numpy()[no_in].any()


@pytest.mark.parametrize("batch", [None, 3])
def test_plain_backward_matches_autograd_with_dropout(batch):
    """The written-out backward == autograd of the plain forward with the
    same Philox mask (dropout on), unbatched and batched."""
    n, k, h, p = 13, 4, 64, 0.25
    d = _stream_inputs(n, k, h, seed=31, batch=batch)
    ei = knn_edge_index(torch.from_numpy(d["pos"]), k)
    args = [a.requires_grad_() for a in _port_args(d, ei)[:6]]
    csr = target_csr(ei, n)
    seed = torch.tensor([4242], dtype=torch.int32)
    out = fused_edge_layer_reference(*args, csr, seed, p)
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    want = torch.autograd.grad(out, args, g_out)
    got = fused_edge_backward_reference(*[a.detach() for a in args], csr,
                                        g_out, seed, p)
    _assert_grads([g.numpy() for g in got], [w.numpy() for w in want])
    # Through the wrapper (a CPU tensor takes the plain versions) too.
    out2 = fused_edge_layer(*args, csr, seed, dropout_p=p,
                            deterministic=False)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    via_fn = torch.autograd.grad(out2, args, g_out)
    _assert_grads([g.numpy() for g in via_fn], [w.numpy() for w in want])


def test_philox_matches_published_vectors():
    """Philox4x32-10 known-answer vectors (Salmon et al., Random123)."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    cases = [((0, 0, 0, 0, 0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 6,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822,
               0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for inputs, want in cases:
        got = philox4x32(*[t(v) for v in inputs])
        assert [int(w) for w in got] == list(want)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_mask_statistics(p):
    """Keep fraction of a (4, 2000, 256) mask within 6 binomial standard
    deviations of 1-p; seeds and graphs give different masks; the same
    seed gives the same mask."""
    b, e, h = 4, 2000, 256
    seed = torch.tensor([97], dtype=torch.int32)
    keep = dropout_keep(seed, p, b, e, h)
    n = keep.numel()
    sd = np.sqrt(n * p * (1 - p))
    assert abs(keep.sum().item() - n * (1 - p)) < 6 * sd
    # every channel position and graph is unbiased too (loose: 6 sd)
    per_chan = keep.float().mean((0, 1))
    assert (per_chan - (1 - p)).abs().max() < 6 * np.sqrt(
        p * (1 - p) / (b * e))
    assert not torch.equal(keep[0], keep[1])
    assert torch.equal(keep, dropout_keep(seed.clone(), p, b, e, h))
    other = dropout_keep(torch.tensor([98], dtype=torch.int32), p, 1, e, h)
    assert not torch.equal(other[0], keep[0])


def test_source_csr_of_row_regular_edges_is_the_identity():
    pos = torch.from_numpy(
        np.random.RandomState(6).randn(2, 11, 3).astype(np.float32))
    ei = knn_edge_index(pos, 3)
    csr = target_csr(ei, 11, sources=True)
    src = csr.sources
    assert torch.equal(src.perm.long(), torch.arange(33).expand(2, -1))
    assert torch.equal(src.dst.long(), ei[:, 1])
    assert torch.equal(src.offsets.long(),
                       (3 * torch.arange(12)).expand(2, -1))


def test_batched_plain_versions_match_jax_batched_kernels():
    """Kernels 8 and 9 (ops/fused_edge_batched.py, interpret mode): the
    port computes their functions with the batch axis of kernels 1 and 2;
    the plain batched forward and backward (B=2, dropout off) agree."""
    n, k, h, b = 16, 4, 32, 2
    d = _stream_inputs(n, k, h, seed=41, batch=b)
    ei = jknn.knn_edge_index(jnp.asarray(d["pos"][0]), k)  # shared edges
    jargs, adj_t = _jax_stream_args(d, ei, n)
    seed = jnp.zeros((1, 1), jnp.int32)
    want_out, vjp = jax.vjp(lambda *a: jfused_edge_layer_batched(
        *a, adj_t, seed, k=k, interpret=True, deterministic=True), *jargs)
    g_out = np.random.RandomState(4).randn(b, n, h).astype(np.float32)
    want = vjp(jnp.asarray(g_out))
    ei_t = torch.tensor(np.asarray(ei)).long().expand(b, -1, -1)
    args = _port_args(d, ei_t)
    got_out = fused_edge_layer_reference(*args)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    got = fused_edge_backward_reference(*args, torch.from_numpy(g_out))
    _assert_grads([g.numpy() for g in got], want)


@pytest.mark.parametrize("b,e,sm_count", [
    (1, 0, 132), (65535, 0, 132),       # no edges
    (1, 3, 132), (2, 7, 132),           # fewer edges than warps
    (1, 8000, 132), (8, 8000, 132), (10, 8000, 132), (24, 8000, 132),
    (65535, 8000, 132), (1, 8000, 1), (1, 1, 1)])
def test_forward_schedule(b, e, sm_count):
    """Kernel 1's (chunk, warps): the same for the same inputs, runs of
    4-32 edges a warp, a chunk the kernel takes, and no warp of a one-block
    graph without edges."""
    chunk, warps = fwd_schedule(b, e, sm_count)
    assert (chunk, warps) == fwd_schedule(b, e, sm_count)
    assert 1 <= warps <= WARPS and chunk % warps == 0
    assert FWD_MIN_RUN <= chunk // warps <= MAX_RUN
    assert chunk <= MAX_CHUNK
    if 0 < e < WARPS * FWD_MIN_RUN:
        assert (warps - 1) * (chunk // warps) < e <= chunk


def test_forward_schedule_at_the_main_paths():
    """At N=200, k=40 on 132 SMs: runs of 4 edges, 8 warps a block at B=1
    (250 blocks); runs of 31-32, 4 warps a block from B=8 up."""
    assert fwd_schedule(1, 8000, 132) == (32, 8)
    assert fwd_schedule(8, 8000, 132) == (124, 4)
    for b in (10, 24):
        assert fwd_schedule(b, 8000, 132) == (128, 4)


def _walk_positions(e, chunk, warps):
    """The CSR positions each warp of a walk takes (csrc/fused_edge.cu):
    block x the positions [x * chunk, min((x + 1) * chunk, e)), its warp w
    the ceil(chunk / warps) of them that start at x * chunk + w * run."""
    run = -(-chunk // warps)
    out = []
    for x in range(max(1, -(-e // chunk))):
        hi = min((x + 1) * chunk, e)
        for w in range(warps):
            a = x * chunk + w * run
            out.extend(range(a, min(a + run, hi)))
    return out


@pytest.mark.parametrize("b,e,sm_count", [
    (1, 0, 132), (65535, 0, 132),       # no edges
    (1, 3, 132), (2, 7, 132),           # fewer edges than warps
    (1, 8000, 132), (8, 8000, 132), (24, 8000, 132), (1, 8001, 132),
    (65535, 8000, 132), (1, 8000, 1), (1, 1, 1), (3, 130, 132)])
def test_backward_schedule(b, e, sm_count):
    """Kernel 2's (chunk, warps), which both its passes walk: the same for
    the same inputs, runs of 4-32 edges a warp, a chunk the kernel takes,
    and every CSR position walked by exactly one warp."""
    chunk, warps = bwd_schedule(b, e, sm_count)
    assert (chunk, warps) == bwd_schedule(b, e, sm_count)
    assert 1 <= warps <= WARPS and chunk % warps == 0
    assert BWD_MIN_RUN <= chunk // warps <= MAX_RUN
    assert chunk <= MAX_CHUNK
    assert sorted(_walk_positions(e, chunk, warps)) == list(range(e))


def test_backward_schedule_at_the_main_paths():
    """At N=200, k=40 on 132 SMs: runs of 8 edges, 8 warps a block at B=1
    (125 blocks); runs of 21, 6 warps a block at the fine-tune's B=8 (508
    blocks); runs of 32, 4 warps a block at training's B=24."""
    assert bwd_schedule(1, 8000, 132) == (64, 8)
    assert bwd_schedule(8, 8000, 132) == (126, 6)
    assert bwd_schedule(24, 8000, 132) == (128, 4)


def test_forward_arrival_counters_are_made_once_a_stream():
    """Kernel 1's counters start at zero and are kept for later launches
    on the same stream (the kernel leaves them zero), made anew only to
    grow; another stream gets its own."""
    cpu = torch.device("cpu")
    first = _arrivals(cpu, 11, 10)
    assert first.dtype == torch.int32 and not first.any()
    assert _arrivals(cpu, 11, first.numel()) is first
    grown = _arrivals(cpu, 11, first.numel() + 1)
    assert grown.numel() > first.numel() and not grown.any()
    assert _arrivals(cpu, 12, 10) is not grown
