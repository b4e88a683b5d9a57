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
// The channel is kept iff word >= round(p * 2^32). The forward and the
// backward regenerate the same mask, so nothing (E, H) is ever stored, and
// the plain PyTorch version (ops/fused_edge.py) draws the same bits.
//
// Forward design (kernel 1). The TPU kernel sums at the targets with one-hot
// (E, N) matmuls; here the wrapper hands over a target-major CSR (edge ids
// stably sorted by target, their sources, per-target offsets) and the
// target of every edge id (`col`). The forward's least time on an H100 is
// set by its float32 operations (bound below); what holds it above that:
//  - at B=1 (serving: 8,000 edges), latency and occupancy: a launch of a
//    few thousand warps, each a chain of dependent steps (load a row, LN
//    statistics through two butterflies, SiLU), and in-degrees far from
//    even (13 to 80+ a graph on the protocol states, thousands at a hub):
//    a block per target would give a hub's warps chains far above the
//    mean while other warps idle;
//  - in training (B=24: 192,000 edges, dropout), the instruction rate: a
//    few hundred instructions an edge (a third of them Philox's) on 4-5
//    warps an SM sub-partition, which stall about as often as they run.
// What the design does:
//  - Work is split by edges, not by targets: block x of graph b takes the
//    CSR positions [x * chunk, (x + 1) * chunk), and each of its warps a
//    run of `per_warp` of them in order, whatever their targets. The
//    longest chain is the run (4 edges at B=1, 31-32 from B=8 up, chosen by
//    the wrapper from the batch, the edge count and the SM count), not the
//    largest in-degree. A warp keeps a running sum per target piece; a
//    target whose edges lie in one run is written by that warp; one split
//    between warps is added in warp order, by its first warp, from the
//    others' rows in shared memory; one split between blocks is written as
//    each block's head or tail row to `part`, and the last block to arrive
//    (an integer counter per first block, reset by that block) adds them in
//    block order. Targets without edges get zero rows from the warp whose
//    run holds their offset. No float atomics: reruns are bit-identical.
//  - One dependent global load an edge: a block stages its slice's edge
//    ids, sources, targets and edge features and W_e (per lane, 16 bytes a
//    read) in shared memory in two coalesced passes, and each edge's
//    source row is loaded while the edge before it is computed. A target's
//    row is loaded once, when the target begins (prefetching it too cost
//    8 registers and measured slower).
//  - Fewer instructions an edge: gamma, beta and the target row live in
//    registers, W_e is read as float4, d = 5 is a compile-time constant,
//    SiLU is y * rcp(1 + ex2(-y log2 e)) with both approximate and without
//    the denormal fix-ups of __expf / __fdividef. Philox is unchanged, bit
//    for bit. Two edges at a time nearly doubled the registers and
//    measured slower.
// Registers (nvcc -Xptxas -v, H=256): 93 with d = 5, 92 otherwise, no
// spills, 22.5 KB of shared memory: 5 blocks of 4 warps or 2 of 8 an SM.
// Times on the card are in PERF.md (chip_smoke.py phase 3).
//
// Backward design (kernel 2), three launches, all sums in a fixed order:
//   A. target-major, one warp per (graph, target), 8 targets per block:
//      recompute the stream of each incoming edge, form
//        dy = mask * g_out[t] / (1-p) * silu'(y),
//        dz = rstd * (dy*gamma - mean(dy*gamma) - x * mean(dy*gamma*x)),
//      keep d_tp[t] = sum dz in registers, write d_ea[e] = dz @ W_e^T when
//      asked, and write the block's partial sums of
//      d_we = sum ea^T dz, d_gamma = sum dy*x, d_beta = sum dy (warps added
//      in order through shared memory);
//   B. source-major over a source CSR, one warp per (graph, source):
//      recompute dz of each outgoing edge, d_sp[s] = sum dz;
//   C. add the per-block partials over blocks and graphs in a fixed order.
//
// Bound on an H100 at the training shape (B=24, N=200, k=40, E=8000, H=256,
// D=5). Forward: ~20 MB of compulsory traffic (6.0 us at 3.35 TB/s) and
// (14 + 2D) * B*E*H = 1.18 GFLOP of float32 work (17.6 us at 67 TFLOP/s),
// plus the Philox integer work. Backward: ~31.5 MB (9.4 us) and about
// (31 + 4D) * B*E*H = 2.5 GFLOP (37 us). Both are bound by float32 work
// outside the tensor cores; the designs keep every (E, H) intermediate in
// registers and recompute the stream instead of storing it (pass B pays a
// second recompute to avoid a 196 MB scratch round trip). The backward's
// pass A walks one dependent chain of a target's ~40 edges a warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_stream.cuh"

namespace {

using namespace nbody_edge;

// dz (and x, dy) of one edge, given the upstream gradient row of its target.
template <int CPL>
__device__ __forceinline__ void edge_dz(const float* tp_row,
                                        const float* sp_row,
                                        const float* go_row,
                                        const float (&a)[kMaxD], int d,
                                        const float* s_we,
                                        const float (&g)[CPL],
                                        const float (&bt)[CPL],
                                        const Dropout& dr, uint32_t eid,
                                        uint32_t b, int lane, float (&x)[CPL],
                                        float (&dy)[CPL], float (&dz)[CPL]) {
  constexpr int H = CPL * 32;
  float z[CPL], mu, rstd, f[CPL];
  edge_z<CPL>(tp_row, sp_row, a, d, s_we, lane, z, mu, rstd);
  mask_factors<CPL>(dr, eid, b, lane, f);
  float m1 = 0.f, m2 = 0.f, dxh[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    x[j] = (z[j] - mu) * rstd;
    const float y = x[j] * g[j] + bt[j];
    const float sig = 1.f / (1.f + expf(-y));
    dy[j] = (go_row[c] * f[j]) * (sig * (1.f + y * (1.f - sig)));
    dxh[j] = dy[j] * g[j];
    m1 += dxh[j];
    m2 += dxh[j] * x[j];
  }
  m1 = warp_sum(m1) * (1.f / H);
  m2 = warp_sum(m2) * (1.f / H);
#pragma unroll
  for (int j = 0; j < CPL; ++j) dz[j] = rstd * (dxh[j] - m1 - x[j] * m2);
}

// Kernel 1's operands and schedule: block x of graph b takes the CSR
// positions [x * chunk, min((x + 1) * chunk, e)), warp w of it the
// per_warp positions that start at x * chunk + w * per_warp.
struct FwdArgs {
  const float* tp;         // (b, n, H)
  const float* sp;         // (b, n, H)
  const float* ea;         // (b, e, d)
  const float* we;         // (d, H)
  const float* gamma;      // (H,)
  const float* beta;       // (H,)
  const int* perm;         // (b, e) edge ids sorted by target
  const int* src;          // (b, e) their sources
  const int* offsets;      // (b, n + 1)
  const long long* col;    // target of each edge id, row stride col_stride
  long long col_stride;
  const int* seed;         // (1,) or null: no dropout
  uint32_t thr;
  float scale;
  float* out;              // (b, n, H)
  float* part;             // (b, nblk, 2, H): a block's head and tail rows
  int* arrivals;           // (b * nblk,) zero before and after each launch
  int n, e, d, chunk, per_warp, nblk;
};

constexpr int kFwdMaxChunk = 128;  // CSR positions a block
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

// silu(y) = y * sigmoid(y) = y / (1 + 2^(-y log2 e)): one MUFU.EX2 and one
// MUFU.RCP, both approximate, denormals flushed (no range fix-ups). For y
// below about -88 the exp is inf, its reciprocal 0 and the result -0.
__device__ __forceinline__ float fast_silu(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return y * r;
}

// acc += dropout(silu(LN(t + s + a W_e) * gamma + beta)) of one edge; `wl`
// is the lane's row of W_e in the LaneWe layout, `a` its d features (d = D
// where D > 0).
template <int CPL, int D>
__device__ __forceinline__ void add_edge(const float (&tr)[CPL],
                                         const float (&sr)[CPL],
                                         const float* a, int d,
                                         const float* wl,
                                         const float (&g)[CPL],
                                         const float (&bt)[CPL],
                                         const Dropout& dr, uint32_t eid,
                                         uint32_t b, int lane,
                                         float (&acc)[CPL]) {
  constexpr int H = CPL * 32;
  using W = LaneWe<CPL>;
  float z[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) z[j] = tr[j] + sr[j];
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
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    s1 += z[j];
    s2 = fmaf(z[j], z[j], s2);
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mu = s1 * (1.f / H);
  const float rstd = rsqrtf(s2 * (1.f / H) - mu * mu + kEps);
  const float shift = -mu * rstd;
  float f[CPL];
  mask_factors<CPL>(dr, eid, b, lane, f);
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const float y = fmaf(fmaf(z[j], rstd, shift), g[j], bt[j]);
    acc[j] = fmaf(fast_silu(y), f[j], acc[j]);
  }
}

// One block: stage the slice's indices, targets, edge features and W_e,
// walk the edges (one warp a run of per_warp positions), then finish the
// rows: a target whose edges lie in one warp's run is written by that warp;
// one split between warps is summed in warp order by the first of them; one
// split between blocks is summed in block order by the last block to arrive.
template <int CPL, int D>  // channels per lane (H = 32 * CPL); d, or 0
__global__ void __launch_bounds__(kWarps * 32)
fused_edge_fwd_kernel(const FwdArgs p) {
  constexpr int H = CPL * 32;
  using W = LaneWe<CPL>;
  __shared__ __align__(16) float s_wl[W::kFloats];
  __shared__ float s_slot[kWarps * H];        // warps' first pieces
  __shared__ float s_ea[kFwdMaxChunk * kMaxD];
  __shared__ int s_perm[kFwdMaxChunk + 2];    // positions lo - 1 .. hi
  __shared__ int s_tgt[kFwdMaxChunk + 2];     // their targets (-1: none)
  __shared__ int s_src[kFwdMaxChunk];
  __shared__ int s_last[2][3];                // (target, j0, j1) to finish

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
  const Dropout dr{p.seed != nullptr,
                   p.seed ? static_cast<uint32_t>(p.seed[0]) : 0u, p.thr,
                   p.scale};

  // Stage 1: the slice's edge ids and sources, W_e, gamma and beta.
  const int* perm_b = p.perm + b * e;
  for (int i = threadIdx.x; i < cnt + 2; i += blockDim.x) {
    const int pos = lo - 1 + i;
    s_perm[i] = pos >= 0 && pos < e ? perm_b[pos] : -1;
  }
  for (int i = threadIdx.x; i < cnt; i += blockDim.x)
    s_src[i] = p.src[b * e + lo + i];
  for (int i = threadIdx.x; i < W::kFloats; i += blockDim.x) {
    const int l = i / W::kStride, k = i % W::kStride / W::CPL4,
              j = i % W::kStride % W::CPL4;
    s_wl[i] = k < d && j < CPL ? p.we[k * H + l + 32 * j] : 0.f;
  }
  float g[CPL], bt[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    g[j] = p.gamma[lane + 32 * j];
    bt[j] = p.beta[lane + 32 * j];
  }
  __syncthreads();
  // Stage 2: each position's target and edge features.
  const long long* col_b = p.col + b * p.col_stride;
  const float* ea_b = p.ea + b * e * d;
  for (int i = threadIdx.x; i < cnt + 2; i += blockDim.x) {
    const int id = s_perm[i];
    s_tgt[i] = id >= 0 ? static_cast<int>(col_b[id]) : -1;
  }
  for (int i = threadIdx.x; i < cnt * d; i += blockDim.x) {
    const int r = i / d;
    s_ea[i] = ea_b[static_cast<long long>(s_perm[r + 1]) * d + (i - r * d)];
  }
  __syncthreads();

  // The target at CSR position pos, for lo - 1 <= pos <= hi.
  auto tgt = [&](int pos) { return s_tgt[pos - lo + 1]; };
  // Targets split with other blocks: the first (begun in an earlier block)
  // and the last (going on past hi); -1 if none, one if the same. Their
  // offsets are loaded now and read at the end.
  const int head = tgt(lo - 1) == tgt(lo) ? tgt(lo) : -1;
  const int tail = tgt(hi) == tgt(hi - 1) && tgt(hi - 1) != head ? tgt(hi - 1)
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
  int cur = -1;          // the target of the run's last piece
  bool pending = false;  // its piece opens a target that goes on past z
  if (a < z) {
    const float* tp_b = p.tp + b * n * H;
    const float* sp_b = p.sp + b * n * H;
    const float* wl = s_wl + lane * W::kStride;
    // A finished piece of target t: kept in acc if t goes on past the run
    // and opens in it, parked in s_slot if it opened in an earlier warp,
    // written out if whole (or as the block's head row if it opened in an
    // earlier block).
    auto finish = [&](int t, bool first, bool last) {
      const bool before = first && tgt(a - 1) == t;
      if (before && warp > 0) {
        store_row<CPL>(s_slot + warp * H, lane, acc);
      } else if (last && tgt(z) == t) {
        pending = true;
      } else {
        store_row<CPL>(before ? part_blk + kHead * H : out_b + t * H, lane,
                       acc);
      }
    };
    cur = tgt(a);
    float tr[CPL], sr[CPL];
    load_row<CPL>(tp_b + cur * H, lane, tr);
    load_row<CPL>(sp_b + s_src[a - lo] * H, lane, sr);
    bool first = true;
    for (int i = a; i < z; ++i) {  // uniform across the warp
      // The next edge's source row is in flight while this edge's
      // arithmetic runs (the last edge loads its own row again). A new
      // target's row is loaded when the target begins: once a target.
      const int ahead = min(i + 1, z - 1);
      const int next = tgt(ahead);
      float sn[CPL];
      load_row<CPL>(sp_b + s_src[ahead - lo] * H, lane, sn);
      add_edge<CPL, D>(tr, sr, s_ea + (i - lo) * d, d, wl, g, bt, dr,
                    static_cast<uint32_t>(s_perm[i - lo + 1]),
                    static_cast<uint32_t>(b), lane, acc);
      if (next != cur) {
        finish(cur, first, false);
        first = false;
        cur = next;
        load_row<CPL>(tp_b + cur * H, lane, tr);
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j) sr[j] = sn[j];
    }
    finish(cur, first, true);

    // Targets without edges: those whose offset is a position p of the run
    // lie between the targets of p - 1 and p; after the last edge come the
    // rest.
    for (int base = a; base < z; base += 32) {
      const int pos = base + lane;
      const int from = pos < z ? tgt(pos - 1) + 1 : 0;
      const int to = pos < z ? tgt(pos) : 0;
      for (unsigned m = __ballot_sync(0xffffffffu, from < to); m; m &= m - 1) {
        const int l = __ffs(m) - 1;
        const int t1 = __shfl_sync(0xffffffffu, to, l);
        for (int t = __shfl_sync(0xffffffffu, from, l); t < t1; ++t)
          zero_row<CPL>(out_b + t * H, lane);
      }
    }
    if (z == e) {
      for (int t = tgt(e - 1) + 1; t < n; ++t) zero_row<CPL>(out_b + t * H, lane);
    }
  }
  __syncthreads();

  // A target split between warps: its first warp adds the later warps'
  // pieces in warp order.
  if (pending) {
    for (int w = warp + 1; w < nwarps; ++w) {
      const int aw = lo + w * p.per_warp;
      if (aw >= hi) break;
      const int zw = min(aw + p.per_warp, hi);
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] += s_slot[w * H + lane + 32 * j];
      if (zw == hi || tgt(zw) != cur) break;
    }
    const bool before = tgt(lo - 1) == cur, after = tgt(hi) == cur;
    store_row<CPL>(before ? part_blk + kHead * H
                   : after ? part_blk + kTail * H
                           : out_b + cur * H,
                   lane, acc);
  }

  // A target split between blocks: each of its blocks has written its row
  // to `part`; the last to arrive adds them in block order and resets the
  // counter for the next launch. Thread 0's fences order the whole block's
  // writes before its arrival and the others' before its reads.
  if (head < 0 && tail < 0) return;  // uniform across the block
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int ts[2] = {head, tail};
    for (int q = 0; q < 2; ++q) {
      s_last[q][0] = -1;
      if (ts[q] < 0) continue;
      const int j0 = span[q][0] / p.chunk;
      const int j1 = (span[q][1] - 1) / p.chunk;
      if (atomicAdd(p.arrivals + b * p.nblk + j0, 1) == j1 - j0) {
        s_last[q][0] = ts[q];
        s_last[q][1] = j0;
        s_last[q][2] = j1;
        p.arrivals[b * p.nblk + j0] = 0;
      }
    }
    __threadfence();
  }
  __syncthreads();
  for (int q = 0; q < 2; ++q) {
    const int t = s_last[q][0];
    if (t < 0) continue;
    const int j0 = s_last[q][1], j1 = s_last[q][2];
    const float* part_b = p.part + b * p.nblk * 2 * H;
    for (int c = threadIdx.x; c < H; c += blockDim.x) {
      float sum = __ldcg(part_b + (j0 * 2 + kTail) * H + c);
      for (int j = j0 + 1; j <= j1; ++j)
        sum += __ldcg(part_b + (j * 2 + kHead) * H + c);
      out_b[t * H + c] = sum;
    }
  }
}

// Adds the block's 8 warp rows `v` in warp order and stores the sum at
// `dst` (H floats). Every thread of the block must call it.
template <int CPL>
__device__ __forceinline__ void block_row_sum(const float (&v)[CPL],
                                              float* s_part, float* dst,
                                              int lane, int warp) {
  constexpr int H = CPL * 32;
#pragma unroll
  for (int j = 0; j < CPL; ++j) s_part[warp * H + lane + 32 * j] = v[j];
  __syncthreads();
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_part[w * H + c];
    dst[c] = s;
  }
  __syncthreads();
}

// Pass A. KD: the widest edge-feature vector the instance handles (d <= KD).
template <int CPL, int KD>
__global__ void __launch_bounds__(kWarps * 32)
fused_edge_bwd_target_kernel(const float* __restrict__ tp,
                             const float* __restrict__ sp,
                             const float* __restrict__ ea,
                             const float* __restrict__ we,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             const int* __restrict__ perm,
                             const int* __restrict__ src,
                             const int* __restrict__ offsets,
                             const float* __restrict__ gout,
                             const int* __restrict__ seed, uint32_t thr,
                             float scale, float* __restrict__ d_tp,
                             float* __restrict__ d_ea,
                             float* __restrict__ part, int n, int e, int d) {
  constexpr int H = CPL * 32;
  __shared__ float s_we[kMaxD * H];
  __shared__ float s_part[kWarps * H];

  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kWarps + warp;
  const bool live = t < n;
  const Dropout dr{seed != nullptr, seed ? static_cast<uint32_t>(seed[0]) : 0u,
                   thr, scale};

  for (int i = threadIdx.x; i < d * H; i += blockDim.x) s_we[i] = we[i];

  float g[CPL], bt[CPL], dtp[CPL], dg[CPL], db[CPL], dwe[KD][CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    g[j] = gamma[c];
    bt[j] = beta[c];
    dtp[j] = dg[j] = db[j] = 0.f;
#pragma unroll
    for (int q = 0; q < KD; ++q) dwe[q][j] = 0.f;
  }
  __syncthreads();

  const float* tp_t = tp + (b * n + t) * H;
  const float* go_t = gout + (b * n + t) * H;
  const float* sp_b = sp + b * n * H;
  const float* ea_b = ea + b * e * d;
  const int* perm_b = perm + b * e;
  const int* src_b = src + b * e;
  const int lo = live ? offsets[b * (n + 1) + t] : 0;
  const int hi = live ? offsets[b * (n + 1) + t + 1] : 0;
  for (int i = lo; i < hi; ++i) {  // uniform across the warp
    const int eid = perm_b[i];
    float a[kMaxD], x[CPL], dy[CPL], dz[CPL];
    load_attr(ea_b + static_cast<long long>(eid) * d, d, a);
    edge_dz<CPL>(tp_t, sp_b + static_cast<long long>(src_b[i]) * H, go_t, a,
                 d, s_we, g, bt, dr, eid, static_cast<uint32_t>(b), lane, x,
                 dy, dz);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      dtp[j] += dz[j];
      dg[j] += dy[j] * x[j];
      db[j] += dy[j];
#pragma unroll
      for (int q = 0; q < KD; ++q) {
        if (q < d) dwe[q][j] = fmaf(a[q], dz[j], dwe[q][j]);
      }
    }
    if (d_ea != nullptr) {
#pragma unroll
      for (int q = 0; q < KD; ++q) {
        if (q < d) {
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < CPL; ++j) v = fmaf(dz[j], s_we[q * H + lane + 32 * j], v);
          v = warp_sum(v);
          if (lane == 0) d_ea[(b * e + eid) * d + q] = v;
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) d_tp[(b * n + t) * H + lane + 32 * j] = dtp[j];
  }

  // This block's partial rows: d_we (d rows), d_gamma, d_beta.
  float* part_blk = part + (b * gridDim.x + blockIdx.x) * (d + 2) * H;
#pragma unroll
  for (int q = 0; q < KD; ++q) {
    if (q < d) block_row_sum<CPL>(dwe[q], s_part, part_blk + q * H, lane, warp);
  }
  block_row_sum<CPL>(dg, s_part, part_blk + d * H, lane, warp);
  block_row_sum<CPL>(db, s_part, part_blk + (d + 1) * H, lane, warp);
}

// Pass B: d_sp over the source-major CSR (edge ids sorted by source, their
// targets, per-source offsets).
template <int CPL>
__global__ void __launch_bounds__(kWarps * 32)
fused_edge_bwd_source_kernel(const float* __restrict__ tp,
                             const float* __restrict__ sp,
                             const float* __restrict__ ea,
                             const float* __restrict__ we,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             const int* __restrict__ sperm,
                             const int* __restrict__ sdst,
                             const int* __restrict__ soffsets,
                             const float* __restrict__ gout,
                             const int* __restrict__ seed, uint32_t thr,
                             float scale, float* __restrict__ d_sp, int n,
                             int e, int d) {
  constexpr int H = CPL * 32;
  __shared__ float s_we[kMaxD * H];

  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + warp;
  const bool live = s < n;
  const Dropout dr{seed != nullptr, seed ? static_cast<uint32_t>(seed[0]) : 0u,
                   thr, scale};

  for (int i = threadIdx.x; i < d * H; i += blockDim.x) s_we[i] = we[i];

  float g[CPL], bt[CPL], dsp[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    g[j] = gamma[c];
    bt[j] = beta[c];
    dsp[j] = 0.f;
  }
  __syncthreads();
  if (!live) return;  // after the only barrier

  const float* sp_s = sp + (b * n + s) * H;
  const float* tp_b = tp + b * n * H;
  const float* go_b = gout + b * n * H;
  const float* ea_b = ea + b * e * d;
  const int* sperm_b = sperm + b * e;
  const int* sdst_b = sdst + b * e;
  const int lo = soffsets[b * (n + 1) + s];
  const int hi = soffsets[b * (n + 1) + s + 1];
  for (int i = lo; i < hi; ++i) {
    const int eid = sperm_b[i];
    const long long t = sdst_b[i];
    float a[kMaxD], x[CPL], dy[CPL], dz[CPL];
    load_attr(ea_b + static_cast<long long>(eid) * d, d, a);
    edge_dz<CPL>(tp_b + t * H, sp_s, go_b + t * H, a, d, s_we, g, bt, dr, eid,
                 static_cast<uint32_t>(b), lane, x, dy, dz);
#pragma unroll
    for (int j = 0; j < CPL; ++j) dsp[j] += dz[j];
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) d_sp[(b * n + s) * H + lane + 32 * j] = dsp[j];
}

// Pass C: out[c] = sum over rows r of part[r * cols + c], rows added in a
// fixed order (warp w takes rows w, w+8, ...; then the warps in order).
__global__ void __launch_bounds__(kWarps * 32)
reduce_rows_kernel(const float* __restrict__ part, int rows, int cols,
                   float* __restrict__ out) {
  __shared__ float s_red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < cols) {
    for (int r = warp; r < rows; r += kWarps) acc += part[static_cast<long long>(r) * cols + col];
  }
  s_red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_red[w][lane];
    out[col] = s;
  }
}

// Blocks a graph in kernel 1: one for a graph without edges.
int fwd_blocks(int e, int chunk) { return e == 0 ? 1 : (e + chunk - 1) / chunk; }

bool bad_shape(int b, int n, int e, int d, int h) {
  return b < 0 || b > 65535 || n < 0 || e < 0 || d < 0 || d > kMaxD ||
         h <= 0 || h % 32 != 0 || h > kMaxH;
}

}  // namespace

// C entry points, loaded with ctypes. Shapes: tp, sp, gout, out, d_tp, d_sp
// (b, n, h); ea, d_ea (b, e, d); we (d, h); gamma, beta (h,); perm, src,
// sperm, sdst (b, e) int32; offsets, soffsets (b, n + 1) int32; col (b, e)
// int64 with row stride col_stride, 0 where the graphs share their edges
// (the target of each edge id); seed (1,)
// int32 or null (no dropout). Forward: chunk <= 128 CSR positions a block
// of `warps` warps; part (b, blocks, 2, h) scratch with blocks = ceil(e /
// chunk), or 1 without edges; arrivals (b * blocks,) int32, all zero, and
// zero again when the launch ends. Backward: part (b, ceil(n / 8), d + 2,
// h) scratch; d_params (d + 2, h) = [d_we; d_gamma; d_beta]. All else
// contiguous, on one device. They launch on `stream` and return
// cudaGetLastError() (0 on success).

extern "C" int nbody_fused_edge_fwd(
    const float* tp, const float* sp, const float* ea, const float* we,
    const float* gamma, const float* beta, const int* perm, const int* src,
    const int* offsets, const long long* col, long long col_stride,
    const int* seed, unsigned int thr, float scale, float* out, float* part,
    int* arrivals, int b, int n, int e, int d, int h, int chunk, int warps,
    void* stream) {
  if (bad_shape(b, n, e, d, h) || warps < 1 || warps > kWarps || chunk < 1 ||
      chunk > kFwdMaxChunk || col_stride < 0 ||
      (col_stride > 0 && col_stride < e)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return 0;
  FwdArgs p{tp, sp, ea, we, gamma, beta, perm, src, offsets, col, col_stride,
            seed, thr, scale, out, part, arrivals, n, e, d, chunk,
            (chunk + warps - 1) / warps, fwd_blocks(e, chunk)};
  const dim3 grid(p.nblk, b);
  const dim3 block(warps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NBODY_LAUNCH(CPL)                                                 \
  if (d == 5) {                                                            \
    fused_edge_fwd_kernel<CPL, 5><<<grid, block, 0, s>>>(p);               \
  } else {                                                                 \
    fused_edge_fwd_kernel<CPL, 0><<<grid, block, 0, s>>>(p);               \
  }
  switch (h / 32) {
    case 1: NBODY_LAUNCH(1); break;
    case 2: NBODY_LAUNCH(2); break;
    case 3: NBODY_LAUNCH(3); break;
    case 4: NBODY_LAUNCH(4); break;
    case 5: NBODY_LAUNCH(5); break;
    case 6: NBODY_LAUNCH(6); break;
    case 7: NBODY_LAUNCH(7); break;
    case 8: NBODY_LAUNCH(8); break;
  }
#undef NBODY_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nbody_fused_edge_bwd(
    const float* tp, const float* sp, const float* ea, const float* we,
    const float* gamma, const float* beta, const int* perm, const int* src,
    const int* offsets, const int* sperm, const int* sdst,
    const int* soffsets, const float* gout, const int* seed,
    unsigned int thr, float scale, float* d_tp, float* d_sp, float* d_ea,
    float* part, float* d_params, int b, int n, int e, int d, int h,
    void* stream) {
  if (bad_shape(b, n, e, d, h)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = (d + 2) * h;
  if (b == 0 || n == 0) {  // no edges: every gradient is zero
    return static_cast<int>(cudaMemsetAsync(d_params, 0, sizeof(float) * cols, s));
  }
  const int nblk = (n + kWarps - 1) / kWarps;
  const dim3 grid(nblk, b);
  const dim3 block(kWarps * 32);
#define NBODY_PASS_A(CPL, KD)                                               \
  fused_edge_bwd_target_kernel<CPL, KD><<<grid, block, 0, s>>>(             \
      tp, sp, ea, we, gamma, beta, perm, src, offsets, gout, seed, thr,     \
      scale, d_tp, d_ea, part, n, e, d)
#define NBODY_PASS_AB(CPL)                                                  \
  if (d <= 5) { NBODY_PASS_A(CPL, 5); } else { NBODY_PASS_A(CPL, 8); }     \
  fused_edge_bwd_source_kernel<CPL><<<grid, block, 0, s>>>(                 \
      tp, sp, ea, we, gamma, beta, sperm, sdst, soffsets, gout, seed, thr,  \
      scale, d_sp, n, e, d)
  switch (h / 32) {
    case 1: NBODY_PASS_AB(1); break;
    case 2: NBODY_PASS_AB(2); break;
    case 3: NBODY_PASS_AB(3); break;
    case 4: NBODY_PASS_AB(4); break;
    case 5: NBODY_PASS_AB(5); break;
    case 6: NBODY_PASS_AB(6); break;
    case 7: NBODY_PASS_AB(7); break;
    case 8: NBODY_PASS_AB(8); break;
  }
#undef NBODY_PASS_AB
#undef NBODY_PASS_A
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_rows_kernel<<<(cols + 31) / 32, kWarps * 32, 0, s>>>(part, b * nblk,
                                                              cols, d_params);
  return static_cast<int>(cudaGetLastError());
}
