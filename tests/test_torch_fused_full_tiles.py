"""Kernel 7's bf16 form: its tensor-core tile, on the CPU.

The kernel (``csrc/fused_edge_full.cuh``, ``tc_product_phase``) runs only
on the card, where ``tests/test_torch_gpu.py`` holds it against its plain
version.  These tests read the header's tile (``struct Tc``) and the index
expressions of ``tc_product_phase`` (the rows each lane hands ``ldmatrix``
and the outputs of its epilogue) and run them in numpy: the items cover
every output once, a tile's ``mma.sync m16n8k16`` fragments give A W^T,
and the eight rows of every ``ldmatrix`` phase fall in distinct
shared-memory banks.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from nbody_gnn_hpc_torch.ops import fused_edge_full as ff

HEADER = (Path(ff.__file__).resolve().parent.parent / "csrc"
          / "fused_edge_full.cuh").read_text()
THREADS = 256  # kThreads (kWarps = 8)


def _tile() -> dict:
    """kWM, kWN, kNT, kKC of the header's ``struct Tc``, and TM, CN and
    LDK as it derives them."""
    body = HEADER[HEADER.index("struct Tc {"):]
    body = body[:body.index("};")]
    c = {k: int(v) for k, v in re.findall(r"\b(k[A-Z]+) = (\d+)", body)}
    for name in ("TM", "CN", "LDK"):
        expr = re.search(rf"\b{name} = ([^,;]+)[,;]", body)[1]
        c[name] = eval(expr, {}, dict(c))
    return c


def _indices() -> dict:
    """The index expressions of tc_product_phase, as the header writes
    them (C's integer division as Python's): name -> a function of the
    names they use.  r0 and c0 are the epilogue's (their last
    definitions)."""
    body = HEADER[HEADER.index("__device__ void tc_product_phase"):]
    body = body[:body.index("\n}\n")]
    out = {}
    for name in ("a_row", "a_col", "b_row", "b_col", "r0", "c0"):
        found = re.findall(rf"\b{name} = ([^,;]+)[,;]", body)
        assert found, name
        expr = found[-1].replace(" / ", " // ")
        out[name] = lambda env, expr=expr: eval(expr, {}, dict(env))
    return out


TC, IDX = _tile(), _indices()


def test_tile_matches_the_kernel_header():
    """The tile is eight warps (4 x 2) of 16 x 32 outputs, 64 x 64 in all,
    taking 16-channel steps through 64-channel chunks whose A rows split
    evenly over the block's threads."""
    assert (TC["TM"], TC["CN"], TC["kKC"]) == (64, 64, 64)
    assert TC["kWM"] * TC["kWN"] == THREADS // 32
    assert TC["kNT"] % 2 == 0 and TC["kKC"] % 16 == 0
    assert TC["TM"] * (TC["kKC"] // 8) % THREADS == 0


def test_items_cover_every_output_once():
    """Item q of a product is the tile at rows (q // slices) TM and outputs
    (q % slices) CN: at every row count and width, the launch's items,
    outputs past the edges masked, write every output exactly once, and
    inside an item the lanes' epilogue stores (r0 + 8 h, c0 + 8 j + 0|1)
    cover the tile exactly once."""
    tm, cn, nt = TC["TM"], TC["CN"], TC["kNT"]
    for rows in (1, 13, 16, 17, 64, 200, 1400, 1600, 4800):
        for n_out in (64, 96, 192, 256, 512):
            slices = -(-n_out // cn)
            hits = np.zeros((rows, n_out), np.int64)
            for q in range(-(-rows // tm) * slices):
                r0, c0 = (q // slices) * tm, (q % slices) * cn
                hits[r0:r0 + tm, c0:c0 + cn] += 1
            assert (hits == 1).all(), (rows, n_out)
    lane = np.arange(32)
    tile_hits = np.zeros((tm, cn), np.int64)
    for warp in range(THREADS // 32):
        env = dict(item=0, slices=1, TM=tm, CN=cn, NT=nt, lane=lane,
                   wm=warp // TC["kWN"], wn=warp % TC["kWN"])
        r0, c0 = IDX["r0"](env), IDX["c0"](env)
        for j in range(nt):
            for h in range(2):
                for u in range(2):
                    np.add.at(tile_hits, (r0 + 8 * h, c0 + 8 * j + u), 1)
    assert (tile_hits == 1).all()


def _ldmatrix_x4(stage, rows, cols):
    """``ldmatrix.x4`` of one warp: lane 8 m + r gives row r of matrix m;
    lane t receives elements 2 (t % 4), + 1 of row t // 4 of each matrix.
    Returns (32 lanes, 4 matrices, 2 values)."""
    out = np.empty((32, 4, 2))
    for m in range(4):
        for t in range(32):
            src = 8 * m + t // 4
            c = cols[src] + 2 * (t % 4)
            out[t, m] = stage[rows[src], c:c + 2]
    return out


def _mma(acc, a, b0, b1):
    """``mma.sync m16n8k16 .row.col``: lane 4 g + u holds A[g, 2u:2u+2]
    (a0), A[g+8, ...] (a1), A[g, 8+2u:...] (a2), A[g+8, 8+2u:...] (a3),
    B[2u:2u+2, g] (b0), B[8+2u:..., g] (b1), C[g, 2u:2u+2] and C[g+8,
    2u:2u+2]."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for t in range(32):
        g, q = t // 4, 2 * (t % 4)
        A[g, q:q + 2], A[g + 8, q:q + 2] = a[t, 0], a[t, 1]
        A[g, q + 8:q + 10], A[g + 8, q + 8:q + 10] = a[t, 2], a[t, 3]
        B[q:q + 2, g], B[q + 8:q + 10, g] = b0[t], b1[t]
    C = A @ B
    for t in range(32):
        g, q = t // 4, 2 * (t % 4)
        acc[t] += (C[g, q], C[g, q + 1], C[g + 8, q], C[g + 8, q + 1])


def _warp_env(warp):
    return dict(item=0, slices=1, TM=TC["TM"], CN=TC["CN"], NT=TC["kNT"],
                lane=np.arange(32), wm=warp // TC["kWN"],
                wn=warp % TC["kWN"])


@pytest.mark.parametrize("k", [256, 96])
def test_fragments_compute_the_tile_product(k):
    """One item's products as tc_product_phase computes them, chunk by
    chunk: the staged rows (A above W, rows LDK = KC + 8 apart), each
    warp's ldmatrix rows (a_row, a_col; b_row, b_col), its mma steps
    (skipped past a part-full last chunk: K = 96) and the epilogue's
    outputs (r0, c0): A W^T, exactly (bf16 operands, float64 here)."""
    tm, cn, nt, kc, ldk = (TC["TM"], TC["CN"], TC["kNT"], TC["kKC"],
                           TC["LDK"])
    rng = np.random.default_rng(k)
    a_mat = rng.standard_normal((tm, k)).round(2)
    w_mat = rng.standard_normal((cn, k)).round(2)
    warps = THREADS // 32
    acc = np.zeros((warps, nt, 32, 4))
    for kc_i in range(-(-k // kc)):
        stage = np.full((tm + cn, ldk), np.nan)
        width = min(kc, k - kc_i * kc)
        stage[:tm, :width] = a_mat[:, kc_i * kc:kc_i * kc + width]
        stage[tm:, :width] = w_mat[:, kc_i * kc:kc_i * kc + width]
        for warp in range(warps):
            env = _warp_env(warp)
            a_row, a_col = IDX["a_row"](env), IDX["a_col"](env)
            b_row, b_col = IDX["b_row"](env), IDX["b_col"](env)
            for kk in range(0, min(kc, k - kc_i * kc), 16):
                a = _ldmatrix_x4(stage, a_row, kk + a_col)
                for np_ in range(nt // 2):
                    w = _ldmatrix_x4(stage, b_row + 16 * np_, kk + b_col)
                    _mma(acc[warp, 2 * np_], a, w[:, 0], w[:, 1])
                    _mma(acc[warp, 2 * np_ + 1], a, w[:, 2], w[:, 3])
    out = np.full((tm, cn), np.nan)
    for warp in range(warps):
        env = _warp_env(warp)
        r0, c0 = IDX["r0"](env), IDX["c0"](env)
        for j in range(nt):
            for h in range(2):
                for u in range(2):
                    out[r0 + 8 * h, c0 + 8 * j + u] = acc[warp, j, :,
                                                          2 * h + u]
    np.testing.assert_allclose(out, a_mat @ w_mat.T, rtol=1e-12, atol=1e-9)


def test_ldmatrix_rows_fall_in_distinct_banks():
    """Each 8-lane phase of the A and W ldmatrix reads (8 rows x 16 bytes)
    covers all 32 shared-memory banks once: staged rows are KC + 8 bf16
    apart; every stage of the ring starts on a 16-byte boundary."""
    tm, cn, nt, kc, ldk = (TC["TM"], TC["CN"], TC["kNT"], TC["kKC"],
                           TC["LDK"])
    assert (tm + cn) * ldk * 2 % 16 == 0
    for warp in range(THREADS // 32):
        env = _warp_env(warp)
        reads = [(IDX["a_row"](env), IDX["a_col"](env))]
        reads += [(IDX["b_row"](env) + 16 * np_, IDX["b_col"](env))
                  for np_ in range(nt // 2)]
        for kk in range(0, kc, 16):
            for rows, cols in reads:
                byte = (rows * ldk + kk + cols) * 2
                assert (byte % 16 == 0).all()
                for m in range(4):
                    words = (byte[8 * m:8 * m + 8, None] // 4
                             + np.arange(4)) % 32
                    assert len(set(words.ravel())) == 32
