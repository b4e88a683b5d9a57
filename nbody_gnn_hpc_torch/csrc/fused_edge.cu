// Fused edge stream of the GNN interaction layer, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels nbody_gnn_hpc_tpu/ops/fused_edge.py
// _fwd_kernel (kernel 1) and _bwd_kernel (kernel 2), and computes the
// functions of their batch-folded twins in ops/fused_edge_batched.py (the
// graph batch is grid.y here). Per graph, with edges e = (row_e -> col_e):
//
//   z_e   = t_proj[col_e] + s_proj[row_e] + edge_attr_e @ W_e          (H,)
//   x_e   = (z_e - mean) * rsqrt(mean(z_e^2) - mean^2 + 1e-6)
//   y_e   = x_e * gamma + beta
//   a_e   = silu(y_e), then in training: keep ? a_e / (1 - p) : 0
//   out_t = sum over edges e with col_e == t of a_e                     (N, H)
//
// Dropout. The TPU kernel draws from the core PRNG, whose bits cannot be
// reproduced; here every (graph b, original edge id e, channel c) draws one
// 32-bit word of Philox4x32-10 keyed on the layer's seed, with counter
// (group(c), e, b, 0) and word c/32 % 4, group(c) = c%32 + 32*(c/128). A lane
// holding channels lane + 32*j gets four of its channels from one Philox call.
// The channel is kept iff word >= round(p * 2^32). The backward draws the
// forward's mask again (once, in its source pass), and the plain PyTorch
// version (ops/fused_edge.py) draws the same bits.
//
// The walk (both kernels). The TPU kernels sum at the targets with one-hot
// (E, N) matmuls; here the wrapper hands over node-major CSRs (edge ids
// stably sorted by target or by source, the other end of each, per-node
// offsets) and the node of every edge id. In-degrees are far from even (13
// to 80+ a graph on the protocol states, thousands at a hub), so work is
// split by edges, not by nodes: block x of graph b takes the CSR positions
// [x * chunk, (x + 1) * chunk), and each of its warps a run of `per_warp` of
// them in order, whatever their nodes. The longest chain is the run (chosen
// by the wrapper from the batch, the edge count and the SM count), not the
// largest degree. A warp keeps a running sum per node piece; a node whose
// edges lie in one run is written by that warp; one split between warps is
// added in warp order, by its first warp, from the others' rows in shared
// memory; one split between blocks is written as each block's head or tail
// row to `part`, and the last block to arrive (an integer counter per first
// block, reset by that block) adds them in block order. Nodes without edges
// get zero rows from the warp whose run holds their offset. No float
// atomics: reruns are bit-identical. A block stages its slice's edge ids,
// other ends, nodes and edge features and W_e (per lane, 16 bytes a read)
// in shared memory, so each edge costs one dependent global load, issued
// while the edge before it is computed; a node's own rows are loaded once,
// when the node begins.
//
// Forward (kernel 1), target-major. Its least time on an H100 is set by its
// float32 operations: at the training shape (B=24, N=200, k=40, E=8000,
// H=256, D=5) ~20 MB of compulsory traffic (6.0 us at 3.35 TB/s) against
// (14 + 2D) * B*E*H = 1.18 GFLOP (17.6 us at 67 TFLOP/s), plus Philox's
// integer work. What held it above that: at B=1 (serving: 8,000 edges) the
// latency of chains set by in-degrees, and in training the instruction
// rate, a few hundred instructions an edge (a third of them Philox's).
// Per edge it does few instructions: gamma, beta and the target row live in
// registers, W_e is read as float4, d = 5 is a compile-time constant, SiLU
// is y * rcp(1 + ex2(-y log2 e)) with both approximate and without the
// denormal fix-ups of __expf / __fdividef. Two edges at a time nearly
// doubled the registers and measured slower. Registers (nvcc -Xptxas -v,
// H=256): 94 with d = 5, no spills: 5 blocks of 4 warps or 2 of 8 an SM.
//
// Backward (kernel 2): the six gradients of the forward for an upstream
// gradient g (ops/fused_edge.py fused_edge_backward_reference):
//   dy_e = mask * g[col_e] / (1-p) * silu'(y_e),
//   m1_e = mean(dy_e*gamma), m2_e = mean(dy_e*gamma*x_e),
//   dz_e = rstd_e * (dy_e*gamma - m1_e - x_e * m2_e),
//   d_t_proj[t] = sum over edges into t of dz, d_s_proj[s] = sum over edges
//   out of s of dz, d_edge_attr_e = dz_e @ W_e^T, d_W_e = sum ea^T dz,
//   d_gamma = sum dy*x, d_beta = sum dy.
// Its least time at the training shape: ~31.5 MB (9.4 us) against about
// (31 + 4D) * B*E*H = 2.5 GFLOP (37 us), bound by float32 work outside the
// tensor cores. The earlier form ran one warp per target (a chain of the
// in-degree, thousands at a hub; at B=1 200 warps on 132 SMs), two
// dependent global loads an edge, scalar W_e reads, an exact sigmoid, and a
// second pass that recomputed the whole stream (both butterflies, Philox)
// for d_s_proj: 20x its bound at B=24, 142x at B=1. Now three launches on
// the walk above, all sums in a fixed order:
//   S. source-major (on the row-regular k-NN graph the source CSR is the
//      edge order): what needs an edge's whole row, once an edge: z, its
//      statistics, the Philox mask, dy, m1, m2 and dz; d_s_proj as the
//      walk's node sums; d_edge_attr when asked (the D dot products reduced
//      together, 9 shuffles for D <= 8). Per edge it writes a record for T:
//      rstd, -mean*rstd, m1, m2 and, in training, the keep bits of its H
//      channels (one word per 32): 48 bytes at H=256, 9.2 MB at B=24, held
//      in the 50 MB L2.
//   T. target-major: per edge z again (the source row gathered, its record
//      staged with the slice), then channel by channel x, y, silu'(y), dy
//      and dz from the record, with no butterflies and no Philox; d_t_proj
//      as the walk's node sums; the warps' sums of d_W_e = ea^T dz, d_gamma
//      and d_beta in registers, added in warp order into one partial row
//      set a block.
//   C. add the blocks' partial parameter rows over blocks and graphs.
// The parameter sums are T's, not S's: they cost 56 registers a lane
// wherever they are. In S (225 registers, 8 warps an SM) they made the
// pass latency-bound; in T both passes stay at or below 170 registers, 12
// warps an SM, and at B=24 the backward measured 0.86x the time on an H100
// (PERF.md). Both passes take the same schedule (ops/fused_edge.py
// bwd_schedule): runs of at least 8 edges, aiming at 24 warps an SM, two
// rounds of those that fit. Registers (nvcc -Xptxas -v, H=256, d = 5): S
// 162, T 167, no spills. Times on the card are in PERF.md (chip_smoke.py
// phase 3; python -m nbody_gnn_hpc_torch.compare_checkouts).

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_stream.cuh"

namespace {

using namespace nbody_edge;

constexpr int kMaxChunk = 128;       // CSR positions a block
constexpr int kHead = 0, kTail = 1;  // rows of `part`

template <int CPL>
__device__ __forceinline__ void load_row(const float* row, int lane,
                                         float (&v)[CPL]) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) v[j] = row[lane + 32 * j];
}

template <int CPL>
__device__ __forceinline__ void store_row(float* row, int lane,
                                          const float (&v)[CPL]) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) row[lane + 32 * j] = v[j];
}

template <int CPL>
__device__ __forceinline__ void zero_row(float* row, int lane) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) row[lane + 32 * j] = 0.f;
}

// sigmoid(y) = 1 / (1 + 2^(-y log2 e)): one MUFU.EX2 and one MUFU.RCP, both
// approximate, denormals flushed (no range fix-ups). For y below about -88
// the exp is inf and the result 0; above about 88 the exp flushes to 0 and
// the result is 1.
__device__ __forceinline__ float fast_sigmoid(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return r;
}

// z = t + s + a W_e of one edge (the lane's channels); `wl` is the lane's row
// of W_e in the LaneWe layout, `a` its d features (d = D where D > 0).
template <int CPL, int D>
__device__ __forceinline__ void stream_z(const float (&t)[CPL],
                                         const float (&s)[CPL], const float* a,
                                         int d, const float* wl,
                                         float (&z)[CPL]) {
  using W = LaneWe<CPL>;
#pragma unroll
  for (int j = 0; j < CPL; ++j) z[j] = t[j] + s[j];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    if (D > 0 ? k < D : k < d) {
      const float ak = a[k];
#pragma unroll
      for (int j0 = 0; j0 < CPL; j0 += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wl + k * W::CPL4 + j0);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j0 + q < CPL) z[j0 + q] = fmaf(ak, w[q], z[j0 + q]);
        }
      }
    }
  }
}

// LayerNorm statistics of z over the warp: x = z * rstd + shift.
template <int CPL>
__device__ __forceinline__ void ln_stats(const float (&z)[CPL], float& rstd,
                                         float& shift) {
  constexpr int H = CPL * 32;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    s1 += z[j];
    s2 = fmaf(z[j], z[j], s2);
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mu = s1 * (1.f / H);
  rstd = rsqrtf(s2 * (1.f / H) - mu * mu + kEps);
  shift = -mu * rstd;
}

// dy = (g * f) * silu'(y), silu'(y) = sig * (1 + y * (1 - sig)).
__device__ __forceinline__ float d_silu(float y, float g, float f) {
  const float sig = fast_sigmoid(y);
  return (g * f) * (sig * fmaf(y, 1.f - sig, 1.f));
}

// Sums v[q] over the warp for eight q at once (a reduce-scatter: 9 shuffles
// where eight butterflies take 40). Lane l ends with the sum for q =
// 4 * bit4(l) + 2 * bit3(l) + bit2(l): lane 4q holds q's.
__device__ __forceinline__ float warp_sum8(const float (&v)[8], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float w4[4], w2[2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float send = h16 ? v[q] : v[q + 4];
    w4[q] = (h16 ? v[q + 4] : v[q]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float send = h8 ? w4[q] : w4[q + 2];
    w2[q] = (h8 ? w4[q + 2] : w4[q]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  float w = (h4 ? w2[1] : w2[0]) +
            __shfl_xor_sync(0xffffffffu, h4 ? w2[0] : w2[1], 4);
  w += __shfl_xor_sync(0xffffffffu, w, 2);
  return w + __shfl_xor_sync(0xffffffffu, w, 1);
}

// A walk over a node-major CSR: block x of graph b takes the positions
// [x * chunk, min((x + 1) * chunk, e)), warp w of it the per_warp positions
// that start at x * chunk + w * per_warp.
struct Walk {
  const int* perm;        // (b, e) edge ids sorted by node
  const int* other;       // (b, e) the other end of each sorted edge
  const int* offsets;     // (b, n + 1)
  const long long* node;  // node of each edge id, row stride node_stride
  long long node_stride;
  const float* ea;        // (b, e, d)
  const float* we;        // (d, H)
  float* out;             // (b, n, H): the sums per node
  float* part;            // (b, nblk, 2, H): a block's head and tail rows
  int* arrivals;          // (b * nblk,) zero before and after each launch
  int n, e, d, chunk, per_warp, nblk;
};

// A block's slice as the walk stages it.
template <int CPL>
struct Staged {
  float wl[LaneWe<CPL>::kFloats];  // W_e, per lane
  float slot[kWarps * CPL * 32];   // warps' first pieces
  float ea[kMaxChunk * kMaxD];     // edge features by position
  int perm[kMaxChunk + 2];         // edge ids at positions lo - 1 .. hi
  int node[kMaxChunk + 2];         // their nodes (-1: none)
  int other[kMaxChunk];            // the other end of each edge
  int last[2][3];                  // (node, j0, j1) to finish
};

// One block's walk: stage the slice, walk the edges (one warp a run of
// per_warp positions), then finish the rows. `Pass` holds a node's own rows
// and computes one edge's term:
//   stage(perm, cnt)   stages its own per-edge data (edge ids perm[0, cnt));
//   begin(node)        loads the node's rows;
//   load(other, rows)  loads the edge's gathered rows (Pass::Rows);
//   edge(rows, pos, other, eid, a, wl, acc)  adds the edge's term to acc
//                      (pos: the edge's position in the slice).
template <int CPL, int D, class Pass>
__device__ __forceinline__ void walk(const Walk& p, Staged<CPL>& s,
                                     Pass& pass) {
  constexpr int H = CPL * 32;
  using W = LaneWe<CPL>;
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n = p.n, e = p.e, d = D > 0 ? D : p.d;
  float* out_b = p.out + b * n * H;
  if (e == 0) {  // no edges: every row is zero
    for (int t = warp; t < n; t += nwarps) zero_row<CPL>(out_b + t * H, lane);
    return;
  }
  const int lo = blockIdx.x * p.chunk;
  const int hi = min(lo + p.chunk, e);
  const int cnt = hi - lo;

  // Stage 1: the slice's edge ids and other ends, W_e.
  const int* perm_b = p.perm + b * e;
  for (int i = threadIdx.x; i < cnt + 2; i += blockDim.x) {
    const int pos = lo - 1 + i;
    s.perm[i] = pos >= 0 && pos < e ? perm_b[pos] : -1;
  }
  for (int i = threadIdx.x; i < cnt; i += blockDim.x)
    s.other[i] = p.other[b * e + lo + i];
  for (int i = threadIdx.x; i < W::kFloats; i += blockDim.x) {
    const int l = i / W::kStride, k = i % W::kStride / W::CPL4,
              j = i % W::kStride % W::CPL4;
    s.wl[i] = k < d && j < CPL ? p.we[k * H + l + 32 * j] : 0.f;
  }
  __syncthreads();
  // Stage 2: each position's node and edge features, the pass's own data.
  const long long* node_b = p.node + b * p.node_stride;
  const float* ea_b = p.ea + b * e * d;
  for (int i = threadIdx.x; i < cnt + 2; i += blockDim.x) {
    const int id = s.perm[i];
    s.node[i] = id >= 0 ? static_cast<int>(node_b[id]) : -1;
  }
  for (int i = threadIdx.x; i < cnt * d; i += blockDim.x) {
    const int r = i / d;
    s.ea[i] = ea_b[static_cast<long long>(s.perm[r + 1]) * d + (i - r * d)];
  }
  pass.stage(s.perm + 1, cnt);
  __syncthreads();

  // The node at CSR position pos, for lo - 1 <= pos <= hi.
  auto key = [&](int pos) { return s.node[pos - lo + 1]; };
  // Nodes split with other blocks: the first (begun in an earlier block)
  // and the last (going on past hi); -1 if none, one if the same. Their
  // offsets are loaded now and read at the end.
  const int head = key(lo - 1) == key(lo) ? key(lo) : -1;
  const int tail = key(hi) == key(hi - 1) && key(hi - 1) != head ? key(hi - 1)
                                                                 : -1;
  int span[2][2] = {{0, 0}, {0, 0}};  // offsets[t], offsets[t + 1]
  if (threadIdx.x == 0) {
    const int* off_b = p.offsets + b * (n + 1);
    if (head >= 0) {
      span[0][0] = off_b[head];
      span[0][1] = off_b[head + 1];
    }
    if (tail >= 0) {
      span[1][0] = off_b[tail];
      span[1][1] = off_b[tail + 1];
    }
  }
  float* part_blk = p.part + (b * p.nblk + blockIdx.x) * 2 * H;
  const int a = lo + warp * p.per_warp;  // this warp's run [a, z)
  const int z = min(a + p.per_warp, hi);
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  int cur = -1;          // the node of the run's last piece
  bool pending = false;  // its piece opens a node that goes on past z
  if (a < z) {
    const float* wl = s.wl + lane * W::kStride;
    // A finished piece of node t: kept in acc if t goes on past the run and
    // opens in it, parked in s.slot if it opened in an earlier warp, written
    // out if whole (or as the block's head row if it opened in an earlier
    // block).
    auto finish = [&](int t, bool first, bool last) {
      const bool before = first && key(a - 1) == t;
      if (before && warp > 0) {
        store_row<CPL>(s.slot + warp * H, lane, acc);
      } else if (last && key(z) == t) {
        pending = true;
      } else {
        store_row<CPL>(before ? part_blk + kHead * H : out_b + t * H, lane,
                       acc);
      }
    };
    cur = key(a);
    pass.begin(cur);
    typename Pass::Rows rows;
    pass.load(s.other[a - lo], rows);
    bool first = true;
    for (int i = a; i < z; ++i) {  // uniform across the warp
      // The next edge's rows are in flight while this edge's arithmetic
      // runs (the last edge loads its own again). A new node's rows are
      // loaded when the node begins: once a node.
      const int ahead = min(i + 1, z - 1);
      const int next = key(ahead);
      typename Pass::Rows rows_next;
      pass.load(s.other[ahead - lo], rows_next);
      pass.edge(rows, i - lo, s.other[i - lo],
                static_cast<uint32_t>(s.perm[i - lo + 1]),
                s.ea + (i - lo) * d, wl, acc);
      if (next != cur) {
        finish(cur, first, false);
        first = false;
        cur = next;
        pass.begin(cur);
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
      }
      rows = rows_next;
    }
    finish(cur, first, true);

    // Nodes without edges: those whose offset is a position p of the run
    // lie between the nodes of p - 1 and p; after the last edge come the
    // rest.
    for (int base = a; base < z; base += 32) {
      const int pos = base + lane;
      const int from = pos < z ? key(pos - 1) + 1 : 0;
      const int to = pos < z ? key(pos) : 0;
      for (unsigned m = __ballot_sync(0xffffffffu, from < to); m; m &= m - 1) {
        const int l = __ffs(m) - 1;
        const int t1 = __shfl_sync(0xffffffffu, to, l);
        for (int t = __shfl_sync(0xffffffffu, from, l); t < t1; ++t)
          zero_row<CPL>(out_b + t * H, lane);
      }
    }
    if (z == e) {
      for (int t = key(e - 1) + 1; t < n; ++t) zero_row<CPL>(out_b + t * H, lane);
    }
  }
  __syncthreads();

  // A node split between warps: its first warp adds the later warps'
  // pieces in warp order.
  if (pending) {
    for (int w = warp + 1; w < nwarps; ++w) {
      const int aw = lo + w * p.per_warp;
      if (aw >= hi) break;
      const int zw = min(aw + p.per_warp, hi);
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] += s.slot[w * H + lane + 32 * j];
      if (zw == hi || key(zw) != cur) break;
    }
    const bool before = key(lo - 1) == cur, after = key(hi) == cur;
    store_row<CPL>(before ? part_blk + kHead * H
                   : after ? part_blk + kTail * H
                           : out_b + cur * H,
                   lane, acc);
  }

  // A node split between blocks: each of its blocks has written its row to
  // `part`; the last to arrive adds them in block order and resets the
  // counter for the next launch. Thread 0's fences order the whole block's
  // writes before its arrival and the others' before its reads.
  if (head < 0 && tail < 0) return;  // uniform across the block
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int ts[2] = {head, tail};
    for (int q = 0; q < 2; ++q) {
      s.last[q][0] = -1;
      if (ts[q] < 0) continue;
      const int j0 = span[q][0] / p.chunk;
      const int j1 = (span[q][1] - 1) / p.chunk;
      if (atomicAdd(p.arrivals + b * p.nblk + j0, 1) == j1 - j0) {
        s.last[q][0] = ts[q];
        s.last[q][1] = j0;
        s.last[q][2] = j1;
        p.arrivals[b * p.nblk + j0] = 0;
      }
    }
    __threadfence();
  }
  __syncthreads();
  for (int q = 0; q < 2; ++q) {
    const int t = s.last[q][0];
    if (t < 0) continue;
    const int j0 = s.last[q][1], j1 = s.last[q][2];
    const float* part_b = p.part + b * p.nblk * 2 * H;
    for (int c = threadIdx.x; c < H; c += blockDim.x) {
      float sum = __ldcg(part_b + (j0 * 2 + kTail) * H + c);
      for (int j = j0 + 1; j <= j1; ++j)
        sum += __ldcg(part_b + (j * 2 + kHead) * H + c);
      out_b[t * H + c] = sum;
    }
  }
}

// What the kernels read beside the walk's operands.
struct StreamArgs {
  const float* tp;      // (b, n, H)
  const float* sp;      // (b, n, H)
  const float* gout;    // (b, n, H), backward only
  const float* gamma;   // (H,)
  const float* beta;    // (H,)
  const int* seed;      // (1,) or null: no dropout
  uint32_t thr;
  float scale;
  uint32_t* rec;        // (b, e, 4 + H/32) records of pass S for pass T
  float* d_ea;          // (b, e, d) or null
  float* part_par;      // (b * nblk, d + 2, H) partial parameter rows
};

template <int CPL>
struct Row {
  float v[CPL];
};

// The parts of a pass that every pass has: gamma and beta in registers, the
// dropout key, the graph.
template <int CPL>
struct PassBase {
  static constexpr int H = CPL * 32;
  float g[CPL], bt[CPL];
  Dropout dr;
  long long b;
  int lane;
  __device__ __forceinline__ PassBase(const StreamArgs& o)
      : dr{o.seed != nullptr, o.seed ? static_cast<uint32_t>(o.seed[0]) : 0u,
           o.thr, o.scale},
        b(blockIdx.y), lane(threadIdx.x & 31) {
    load_row<CPL>(o.gamma, lane, g);
    load_row<CPL>(o.beta, lane, bt);
  }
  __device__ __forceinline__ void stage(const int*, int) {}
};

// Kernel 1: acc += dropout(silu(LN(t + s + a W_e) * gamma + beta)) over the
// edges into a target; the node is the target, the gathered row the source's.
template <int CPL, int D>
struct ForwardPass : PassBase<CPL> {
  using B = PassBase<CPL>;
  using Rows = Row<CPL>;
  static constexpr int H = B::H;
  const float* tp_b;
  const float* sp_b;
  int d;
  float tr[CPL];
  __device__ __forceinline__ ForwardPass(const StreamArgs& o, int n, int d_)
      : B(o), tp_b(o.tp + B::b * n * H), sp_b(o.sp + B::b * n * H), d(d_) {}
  __device__ __forceinline__ void begin(int t) {
    load_row<CPL>(tp_b + t * H, B::lane, tr);
  }
  __device__ __forceinline__ void load(int src, Rows& r) {
    load_row<CPL>(sp_b + src * H, B::lane, r.v);
  }
  __device__ __forceinline__ void edge(const Rows& r, int, int, uint32_t eid,
                                       const float* a, const float* wl,
                                       float (&acc)[CPL]) {
    float z[CPL], rstd, shift, f[CPL];
    stream_z<CPL, D>(tr, r.v, a, d, wl, z);
    ln_stats<CPL>(z, rstd, shift);
    mask_factors<CPL>(B::dr, eid, static_cast<uint32_t>(B::b), B::lane, f);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float y = fmaf(fmaf(z[j], rstd, shift), B::g[j], B::bt[j]);
      acc[j] = fmaf(y * fast_sigmoid(y), f[j], acc[j]);
    }
  }
};

// Words of pass S's record of one edge: rstd, shift, m1, m2, then in
// training the keep bits (word j: channel lane + 32j kept, in bit lane).
template <int CPL>
struct Record {
  static constexpr int kWords = 4 + CPL;
  static constexpr int kStride = 4 + LaneWe<CPL>::CPL4;  // staged, 16 B aligned
};

// Backward pass S: the node is the source, the gathered row the target's
// t_proj (its g row is loaded inside the edge, used after the statistics).
// The work that needs the whole row of an edge, once: the statistics, the
// mask, m1, m2 and dz; writes the edge's record for pass T and d_edge_attr
// when asked; the walk sums dz into d_s_proj.
template <int CPL, int D>
struct SourcePass : PassBase<CPL> {
  using B = PassBase<CPL>;
  using Rows = Row<CPL>;
  static constexpr int H = B::H;
  const float* tp_b;
  const float* go_b;
  const float* sp_b;
  uint32_t* rec_b;
  float* dea_b;
  int d;
  float sr[CPL];
  __device__ __forceinline__ SourcePass(const StreamArgs& o, int n, int e,
                                        int d_)
      : B(o), tp_b(o.tp + B::b * n * H), go_b(o.gout + B::b * n * H),
        sp_b(o.sp + B::b * n * H),
        rec_b(o.rec + B::b * e * Record<CPL>::kWords),
        dea_b(o.d_ea ? o.d_ea + B::b * e * d_ : nullptr), d(d_) {}
  __device__ __forceinline__ void begin(int s) {
    load_row<CPL>(sp_b + s * H, B::lane, sr);
  }
  __device__ __forceinline__ void load(int t, Rows& r) {
    load_row<CPL>(tp_b + t * H, B::lane, r.v);
  }
  __device__ __forceinline__ void edge(const Rows& r, int, int t,
                                       uint32_t eid, const float* a,
                                       const float* wl, float (&acc)[CPL]) {
    using W = LaneWe<CPL>;
    const int lane = B::lane;
    float go[CPL], z[CPL], rstd, shift, f[CPL];
    load_row<CPL>(go_b + t * H, lane, go);
    stream_z<CPL, D>(r.v, sr, a, d, wl, z);
    ln_stats<CPL>(z, rstd, shift);
    mask_factors<CPL>(B::dr, eid, static_cast<uint32_t>(B::b), lane, f);
    float x[CPL], dy[CPL], m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      x[j] = fmaf(z[j], rstd, shift);
      dy[j] = d_silu(fmaf(x[j], B::g[j], B::bt[j]), go[j], f[j]);
      const float dxh = dy[j] * B::g[j];
      m1 += dxh;
      m2 = fmaf(dxh, x[j], m2);
    }
    m1 = warp_sum(m1) * (1.f / H);
    m2 = warp_sum(m2) * (1.f / H);
    float dz[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      dz[j] = rstd * (dy[j] * B::g[j] - m1 - x[j] * m2);
      acc[j] += dz[j];
    }
    // The record: lanes 0-3 the four scalars, lanes 4.. the keep bits.
    uint32_t word = __float_as_uint(lane == 0 ? rstd
                                    : lane == 1 ? shift
                                    : lane == 2 ? m1
                                                : m2);
    if (B::dr.on) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const uint32_t bits = __ballot_sync(0xffffffffu, f[j] != 0.f);
        if (lane == 4 + j) word = bits;
      }
    }
    if (lane < (B::dr.on ? Record<CPL>::kWords : 4))
      rec_b[eid * Record<CPL>::kWords + lane] = word;
    if (dea_b != nullptr) {  // d_edge_attr = dz W_e^T
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = 0.f;
        if (k < kMaxD && (D > 0 ? k < D : k < d)) {
#pragma unroll
          for (int j0 = 0; j0 < CPL; j0 += 4) {
            const float4 w4 =
                *reinterpret_cast<const float4*>(wl + k * W::CPL4 + j0);
            const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (j0 + q < CPL) v[k] = fmaf(dz[j0 + q], w[q], v[k]);
            }
          }
        }
      }
      const float sum = warp_sum8(v, lane);
      if ((lane & 3) == 0 && lane / 4 < d)
        dea_b[static_cast<long long>(eid) * d + lane / 4] = sum;
    }
  }
};

// Backward pass T: the node is the target (its t_proj and g rows), the
// gathered row the source's s_proj. dy and dz of each edge from z and pass
// S's record, channel by channel; the walk sums dz into d_t_proj, and the
// warp keeps its sums of d_W_e, d_gamma and d_beta.
template <int CPL, int D>
struct TargetPass : PassBase<CPL> {
  using B = PassBase<CPL>;
  using Rows = Row<CPL>;
  using R = Record<CPL>;
  static constexpr int H = B::H;
  static constexpr int KD = D > 0 ? D : kMaxD;
  const float* tp_b;
  const float* go_b;
  const float* sp_b;
  const uint32_t* rec_b;
  uint32_t* s_rec;  // (kMaxChunk, R::kStride) staged records
  int d;
  float tr[CPL], go[CPL];
  float dwe[KD][CPL], dg[CPL], db[CPL];
  __device__ __forceinline__ TargetPass(const StreamArgs& o, int n, int e,
                                        int d_, uint32_t* s_rec_)
      : B(o), tp_b(o.tp + B::b * n * H), go_b(o.gout + B::b * n * H),
        sp_b(o.sp + B::b * n * H), rec_b(o.rec + B::b * e * R::kWords),
        s_rec(s_rec_), d(d_) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      dg[j] = db[j] = 0.f;
#pragma unroll
      for (int k = 0; k < KD; ++k) dwe[k][j] = 0.f;
    }
  }
  __device__ __forceinline__ void stage(const int* perm, int cnt) {
    const int words = B::dr.on ? R::kWords : 4;
    for (int i = threadIdx.x; i < cnt * words; i += blockDim.x) {
      const int r = i / words, w = i - r * words;
      s_rec[r * R::kStride + w] = rec_b[perm[r] * R::kWords + w];
    }
  }
  __device__ __forceinline__ void begin(int t) {
    load_row<CPL>(tp_b + t * H, B::lane, tr);
    load_row<CPL>(go_b + t * H, B::lane, go);
  }
  __device__ __forceinline__ void load(int src, Rows& r) {
    load_row<CPL>(sp_b + src * H, B::lane, r.v);
  }
  __device__ __forceinline__ void edge(const Rows& r, int pos, int, uint32_t,
                                       const float* a, const float* wl,
                                       float (&acc)[CPL]) {
    const uint32_t* rc = s_rec + pos * R::kStride;
    const float4 st = *reinterpret_cast<const float4*>(rc);
    const float rstd = st.x, shift = st.y, m1 = st.z, m2 = st.w;
    float z[CPL];
    stream_z<CPL, D>(tr, r.v, a, d, wl, z);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float f = !B::dr.on                    ? 1.f
                      : (rc[4 + j] >> B::lane) & 1u ? B::dr.scale
                                                    : 0.f;
      const float x = fmaf(z[j], rstd, shift);
      const float dy = d_silu(fmaf(x, B::g[j], B::bt[j]), go[j], f);
      const float dz = rstd * (dy * B::g[j] - m1 - x * m2);
      acc[j] += dz;
      dg[j] = fmaf(dy, x, dg[j]);
      db[j] += dy;
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        if (D > 0 || k < d) dwe[k][j] = fmaf(a[k], dz, dwe[k][j]);
      }
    }
  }
};

template <int CPL, int D>
__global__ void __launch_bounds__(kWarps * 32)
fused_edge_fwd_kernel(const Walk w, const StreamArgs o) {
  __shared__ __align__(16) Staged<CPL> s;
  ForwardPass<CPL, D> pass(o, w.n, D > 0 ? D : w.d);
  walk<CPL, D>(w, s, pass);
}

template <int CPL, int D>
__global__ void __launch_bounds__(kWarps * 32)
fused_edge_bwd_source_kernel(const Walk w, const StreamArgs o) {
  __shared__ __align__(16) Staged<CPL> s;
  SourcePass<CPL, D> pass(o, w.n, w.e, D > 0 ? D : w.d);
  walk<CPL, D>(w, s, pass);
}

template <int CPL, int D>
__global__ void __launch_bounds__(kWarps * 32)
fused_edge_bwd_target_kernel(const Walk w, const StreamArgs o) {
  constexpr int H = CPL * 32;
  __shared__ __align__(16) Staged<CPL> s;
  __shared__ __align__(16) uint32_t s_rec[kMaxChunk * Record<CPL>::kStride];
  extern __shared__ float s_par[];  // (warps, d + 2, H)
  const int d = D > 0 ? D : w.d;
  TargetPass<CPL, D> pass(o, w.n, w.e, d, s_rec);
  walk<CPL, D>(w, s, pass);

  // The block's partial rows of d_W_e, d_gamma and d_beta: its warps' rows
  // added in warp order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5, cols = (d + 2) * H;
  float* mine = s_par + warp * cols;
#pragma unroll
  for (int k = 0; k < TargetPass<CPL, D>::KD; ++k) {
    if (k < d) store_row<CPL>(mine + k * H, lane, pass.dwe[k]);
  }
  store_row<CPL>(mine + d * H, lane, pass.dg);
  store_row<CPL>(mine + (d + 1) * H, lane, pass.db);
  __syncthreads();
  float* dst = o.part_par +
               (static_cast<long long>(blockIdx.y) * w.nblk + blockIdx.x) * cols;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float sum = 0.f;
    for (int v = 0; v < nwarps; ++v) sum += s_par[v * cols + c];
    dst[c] = sum;
  }
}

// Pass C: out[c] = sum over rows r of part[r * cols + c], rows added in a
// fixed order (warp w takes rows w, w+32, ...; then the warps in order).
constexpr int kSumWarps = 32;
__global__ void __launch_bounds__(kSumWarps * 32)
reduce_rows_kernel(const float* __restrict__ part, int rows, int cols,
                   float* __restrict__ out) {
  __shared__ float s_red[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < cols) {
    for (int r = warp; r < rows; r += kSumWarps) acc += part[static_cast<long long>(r) * cols + col];
  }
  s_red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) s += s_red[w][lane];
    out[col] = s;
  }
}

// Blocks a graph in a walk: one for a graph without edges.
int walk_blocks(int e, int chunk) { return e == 0 ? 1 : (e + chunk - 1) / chunk; }

bool bad_shape(int b, int n, int e, int d, int h) {
  return b < 0 || b > 65535 || n < 0 || e < 0 || d < 0 || d > kMaxD ||
         h <= 0 || h % 32 != 0 || h > kMaxH;
}

bool bad_walk(int e, int chunk, int warps, long long stride) {
  return warps < 1 || warps > kWarps || chunk < 1 || chunk > kMaxChunk ||
         stride < 0 || (stride > 0 && stride < e);
}

// Calls LAUNCH(CPL, D) for h = 32 * CPL, with D = 5 where d is 5 and the
// generic D = 0 otherwise.
#define NBODY_DISPATCH(h, d, LAUNCH)        \
  switch ((h) / 32) {                       \
    case 1: NBODY_BY_D(1, d, LAUNCH); break; \
    case 2: NBODY_BY_D(2, d, LAUNCH); break; \
    case 3: NBODY_BY_D(3, d, LAUNCH); break; \
    case 4: NBODY_BY_D(4, d, LAUNCH); break; \
    case 5: NBODY_BY_D(5, d, LAUNCH); break; \
    case 6: NBODY_BY_D(6, d, LAUNCH); break; \
    case 7: NBODY_BY_D(7, d, LAUNCH); break; \
    case 8: NBODY_BY_D(8, d, LAUNCH); break; \
  }
#define NBODY_BY_D(CPL, d, LAUNCH) \
  if ((d) == 5) {                  \
    LAUNCH(CPL, 5);                \
  } else {                         \
    LAUNCH(CPL, 0);                \
  }

}  // namespace

// C entry points, loaded with ctypes. Shapes: tp, sp, gout, out, d_tp, d_sp
// (b, n, h); ea, d_ea (b, e, d); we (d, h); gamma, beta (h,); perm, src (b, e)
// int32, the target-major CSR; sperm, sdst (b, e) int32, the source-major
// CSR; offsets, soffsets (b, n + 1) int32; col, row (b, e) int64 with row
// stride col_stride, row_stride, 0 where the graphs share their edges (the
// target and source of each edge id); seed (1,) int32 or null (no dropout).
// Both walks: chunk <= 128 CSR positions a block of `warps` warps; part (b,
// blocks, 2, h) scratch with blocks = ceil(e / chunk), or 1 without edges;
// arrivals (b * blocks,) int32, all zero, and zero again when the launch
// ends. Backward: rec (b, e, 4 + h / 32) int32 and part_par (b * blocks, d +
// 2, h) scratch; d_params (d + 2, h) = [d_we; d_gamma; d_beta]; d_ea null
// where not wanted. All else contiguous, on one device. They launch on
// `stream` and return the first CUDA error (0 on success).

extern "C" int nbody_fused_edge_fwd(
    const float* tp, const float* sp, const float* ea, const float* we,
    const float* gamma, const float* beta, const int* perm, const int* src,
    const int* offsets, const long long* col, long long col_stride,
    const int* seed, unsigned int thr, float scale, float* out, float* part,
    int* arrivals, int b, int n, int e, int d, int h, int chunk, int warps,
    void* stream) {
  if (bad_shape(b, n, e, d, h) || bad_walk(e, chunk, warps, col_stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return 0;
  const Walk w{perm, src, offsets, col, col_stride, ea, we, out, part,
               arrivals, n, e, d, chunk, (chunk + warps - 1) / warps,
               walk_blocks(e, chunk)};
  const StreamArgs o{tp, sp, nullptr, gamma, beta, seed, thr, scale,
                     nullptr, nullptr, nullptr};
  const dim3 grid(w.nblk, b);
  const dim3 block(warps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NBODY_FWD(CPL, D) fused_edge_fwd_kernel<CPL, D><<<grid, block, 0, s>>>(w, o)
  NBODY_DISPATCH(h, d, NBODY_FWD)
#undef NBODY_FWD
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nbody_fused_edge_bwd(
    const float* tp, const float* sp, const float* ea, const float* we,
    const float* gamma, const float* beta, const int* perm, const int* src,
    const int* offsets, const long long* col, long long col_stride,
    const int* sperm, const int* sdst, const int* soffsets,
    const long long* row, long long row_stride, const float* gout,
    const int* seed, unsigned int thr, float scale, float* d_tp, float* d_sp,
    float* d_ea, float* part, int* arrivals, unsigned int* rec,
    float* part_par, float* d_params, int b, int n, int e, int d, int h,
    int chunk, int warps, void* stream) {
  if (bad_shape(b, n, e, d, h) || bad_walk(e, chunk, warps, col_stride) ||
      bad_walk(e, chunk, warps, row_stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = (d + 2) * h;
  if (b == 0 || n == 0 || e == 0) {  // no edges: every gradient is zero
    const size_t rows = sizeof(float) * b * n * h;
    cudaError_t err = cudaMemsetAsync(d_params, 0, sizeof(float) * cols, s);
    if (err == cudaSuccess && rows > 0) err = cudaMemsetAsync(d_tp, 0, rows, s);
    if (err == cudaSuccess && rows > 0) err = cudaMemsetAsync(d_sp, 0, rows, s);
    return static_cast<int>(err);
  }
  const int per_warp = (chunk + warps - 1) / warps, nblk = walk_blocks(e, chunk);
  const Walk ws{sperm, sdst, soffsets, row, row_stride, ea, we, d_sp, part,
                arrivals, n, e, d, chunk, per_warp, nblk};
  const Walk wt{perm, src, offsets, col, col_stride, ea, we, d_tp, part,
                arrivals, n, e, d, chunk, per_warp, nblk};
  const StreamArgs o{tp, sp, gout, gamma, beta, seed, thr, scale, rec, d_ea,
                     part_par};
  const dim3 grid(nblk, b);
  const dim3 block(warps * 32);
  const int par_bytes = static_cast<int>(sizeof(float)) * warps * cols;
  cudaError_t err = cudaSuccess;
#define NBODY_BWD(CPL, D)                                                   \
  err = cudaFuncSetAttribute(fused_edge_bwd_target_kernel<CPL, D>,         \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                             par_bytes);                                   \
  if (err != cudaSuccess) return static_cast<int>(err);                    \
  fused_edge_bwd_source_kernel<CPL, D><<<grid, block, 0, s>>>(ws, o);      \
  fused_edge_bwd_target_kernel<CPL, D><<<grid, block, par_bytes, s>>>(wt, o)
  NBODY_DISPATCH(h, d, NBODY_BWD)
#undef NBODY_BWD
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_rows_kernel<<<(cols + 31) / 32, kSumWarps * 32, 0, s>>>(
      part_par, b * nblk, cols, d_params);
  return static_cast<int>(cudaGetLastError());
}
