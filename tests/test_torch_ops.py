"""Port graph ops (nbody_gnn_hpc_torch/ops) against the JAX package's.

Inputs come from a seeded numpy RNG and go through both frameworks as numpy
arrays.  The fused edge stream's plain version is held against the JAX
Pallas kernel in interpret mode (the JAX package's own CPU route).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.ops import (edge_features, edge_index_for,
                                     fully_connected_edge_index,
                                     fused_edge_layer,
                                     fused_edge_layer_reference,
                                     is_row_regular, knn_edge_index,
                                     target_csr)
from nbody_gnn_hpc_tpu.models.gnn import target_adjacency
from nbody_gnn_hpc_tpu.ops import edges as jedges
from nbody_gnn_hpc_tpu.ops import knn as jknn
from nbody_gnn_hpc_tpu.ops.fused_edge import \
    fused_edge_layer as jfused_edge_layer

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
    with pytest.raises(NotImplementedError):
        fused_edge_layer(*args, dropout_p=0.1, deterministic=False)
    meta = [a.to("meta") for a in args[:6]]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_edge_layer(*meta, args[6])
