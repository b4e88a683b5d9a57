// The whole GNN interaction layer as one kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nbody_gnn_hpc_tpu/ops/fused_edge_full.py
// _full_fwd_kernel (kernel 7). Per graph, with edges e = (row_e -> col_e),
// all float32, weights in torch.nn.Linear's (out, in) layout:
//
//   t      = h Wt^T + bt ;  s = h Ws^T                                (N, H)
//   summed = the edge stream of fused_edge.cu over t, s, edge_attr    (N, H)
//            (gather, + edge_attr We^T, LayerNorm, SiLU, Philox dropout
//            with the same keying, sum at the targets)
//   agg    = summed Wout^T + deg (x) bout                             (N, H)
//   z1     = h W1[:, :H]^T + agg W1[:, H:]^T + b1                     (N, H)
//   a      = silu(LayerNorm(z1) * g1 + be1)   (fast variance, eps 1e-6)
//            times the pre-scaled node mask in training
//   h_new  = a W2^T + b2                                              (N, Ho)
//
// and writes h_new and summed (the backward needs summed).
//
// Design. The TPU kernel runs its grid in order: the first step fills fast
// memory with t and s, the last step runs the node side. CUDA blocks have no
// order, so the layer is six phases over the whole grid, each reading what
// an earlier one wrote to global scratch (a few MB a batch, which stays in
// the 50 MB L2 cache, read with plain or L2-only loads, never through the
// read-only cache):
//
//   P1  [t, s] = h [Wt; Ws]^T + [bt, 0]    -> scratch tp, sp     product
//   P2  the edge stream                    -> summed             warps
//   P3  agg = summed Wout^T + deg (x) bout -> scratch agg        product
//   P4  z1 = [h, agg] W1^T + b1            -> scratch z1         product
//   P5  a = silu(LN(z1) g1 + be1) * mask   -> z1, in place       warp a row
//   P6  h_new = a W2^T + b2                -> h_new              product
//
// with a grid-wide barrier (cooperative_groups grid.sync) between phases.
// It is launched cooperatively (cudaLaunchCooperativeKernel) with a
// persistent grid of at most (resident blocks per SM) x (SMs) blocks, every
// SM full, that loop over each phase's items, so any batch fits: one launch
// per layer. Where the device reports no cooperative launch, or the caller
// asks for it, the six phases run as six ordinary launches of the same
// kernel. The schedule (tile shape, warps a target) is a function of the
// shape and the device alone, and an item's arithmetic does not depend on
// the block that runs it, so both forms give the same bits.
//
// Products. The design before this one (8-row tiles, the whole node side of
// a tile in one block, two phases) took 162 us at B=1 on an H100 against a
// 3 us bound and lost to the composed PyTorch layer: 25 to 50 busy SMs, each
// staging weights with loads nothing overlapped and streaming all of them
// again for every 8 rows. Here a product item is one output tile over the
// rows of all graphs at once (rows of a batch are rows of one matrix): 16 x
// 16 ("Narrow": 416 items in P1 and 208 in P3, P4, P6 at B=1) or, where
// there are at least as many such items as resident blocks, 32 x 32 ("Mid":
// B=8 and B=24), which reads half the L2 bytes per operation. An item owns
// its outputs, so no atomics. Its operand rows and its weight slice go
// through shared memory in chunks of 128 (Narrow) or 64 (Mid) channels, in
// a ring of three stages filled with 16-byte cp.async.cg copies; a block's
// items are one pipeline of (item, chunk) steps, so the next chunks, also
// those of the next item, are in flight while the FMAs run. A thread holds
// a 4 x 4 block of outputs (with 2 x 2 blocks, four 16-byte shared-memory
// reads per 16 FMAs bound the products), and the depth of a chunk is split
// 16 (Narrow) or 4 (Mid) ways between groups of threads, whose partial sums
// are added in a fixed order. Rows of a staged chunk are
// padded (132 or 68 floats) so eight neighbouring rows fall in distinct
// banks.
//
// LayerNorm (P5) is a phase of its own, not a step of P6's items: one warp
// computes a row's statistics once, in one order, and every column item of
// P6 reads the same a; a 32-row tile of a in shared memory beside the ring
// would leave two blocks an SM instead of three.
//
// The stream (P2) gives each target `split` warps (1 to 8: the fewest
// rounds of the longest chain over the resident warps: 8 at B=1, 8 and
// 24); share s takes the edges lo + s, lo + s + split, ... in CSR
// order, and the shares are added in order. One edge at a time: two at a
// time, and loading the next edge's rows ahead, both needed more registers
// than three blocks an SM allow and measured slower. We^T sits in shared
// memory in a per-lane layout read 16 bytes at a time.
//
// No float atomics; every sum is taken in a fixed order, so reruns are
// bit-identical. Float32 FMA only (TF32 does not hold the tests' 1e-5).
//
// Bound on an H100 at the serving shape (B=1, N=200, k=40, E=8000, H=Ho=256,
// D=5): 2*N*H*(5H+Ho) = 157 MFLOP of products plus the stream's 23*E*H =
// 47 MFLOP, 3.0 us at 67 TFLOP/s float32 outside the tensor cores; against
// 2.5 MB (h, h_new, summed, edge_attr, the CSR and 1.5 MB of weights), 0.75
// us at 3.35 TB/s. Bound by operations. What the design pays beyond it
// (measured on an H100 80GB HBM3 at 700 W, each phase as its own launch):
// at B=1 the stream (~15 us: chains of ~5 dependent edges) and five grid
// barriers; at B=24 (training) the stream, ~160 us at ~1 ns an edge, and the
// products, ~200 us at ~18 TFLOP/s. Times on the card are in PERF.md
// (chip_smoke.py phase 3).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_stream.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nbody_edge;

constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;  // staged chunks in the ring
constexpr int kPhases = 6;
constexpr int kMinBlocks = 3;  // resident blocks an SM (registers <= 80)

// An item's output tile and how the block's threads share it: each thread
// holds an R x R block of outputs (rows gy + G*i, columns gx + G*j of the
// tile), and the depth of every staged chunk of KC channels is split KS
// ways between groups of threads whose partial sums are added in order.
template <int R, int KS, int KC>
struct Tiling {
  static constexpr int kShare = kThreads / KS;  // threads of a depth share
  static constexpr int G =                      // side of its thread grid
      kShare == 16 ? 4 : kShare == 64 ? 8 : 16;
  static constexpr int TM = G * R, CN = G * R;  // rows, output channels
  static constexpr int kKC = KC, kKS = KS, kR = R;
  static constexpr int LDK = KC + 4;  // padded: 8 neighbouring rows, 8 banks
  static constexpr int kStage = (TM + CN) * LDK;
  static constexpr int kSegs = (TM + CN) * (KC / 4);  // 16-byte copies
  static constexpr int QK = KC / KS;
  static_assert(G * G * KS == kThreads, "a share is a square thread grid");
};
using Narrow = Tiling<4, 16, 128>;  // 16 x 16 outputs, depth split 16 ways
using Mid = Tiling<4, 4, 64>;       // 32 x 32 outputs, depth split 4 ways
constexpr int kRingFloats =
    kStages * (Narrow::kStage > Mid::kStage ? Narrow::kStage : Mid::kStage);
constexpr int kRedFloats = Narrow::kKS * Narrow::TM * Narrow::CN >
                                   Mid::kKS * Mid::TM * Mid::CN
                               ? Narrow::kKS * Narrow::TM * Narrow::CN
                               : Mid::kKS * Mid::TM * Mid::CN;
static_assert(kRingFloats >= kWarps * kMaxH + 32 * (kMaxD * kMaxH / 32 + 4),
              "P2 shares and We^T fit in the ring");

struct LayerArgs {
  // inputs
  const float* h;          // (b, n, H)
  const float* ea;         // (b, e, d)
  const int* perm;         // (b, e) edge ids sorted by target
  const int* src;          // (b, e) source of each sorted edge
  const int* offsets;      // (b, n + 1)
  const float* wt;         // (H, H)   edge_proj_target.weight
  const float* bt;         // (H,)
  const float* ws;         // (H, H)   edge_proj_source.weight
  const float* we;         // (H, d)   edge_proj_attr.weight
  const float* ge;         // (H,)     edge_norm
  const float* be;         // (H,)
  const float* wout;       // (H, H)   edge_out.weight
  const float* bout;       // (H,)
  const float* w1;         // (H, 2H)  node_mlp.Dense_0.weight
  const float* b1;         // (H,)
  const float* g1;         // (H,)     node_mlp.LayerNorm_0
  const float* be1;        // (H,)
  const float* w2;         // (Ho, H)  node_mlp.Dense_1.weight
  const float* b2;         // (Ho,)
  const float* node_mask;  // (b, n, H) pre-scaled, or null
  const int* seed;         // (1,) or null (no edge dropout)
  uint32_t thr;
  float scale;
  uint32_t graph0;         // batch index of graph 0 (Dropout::graph0)
  // scratch, each written in one phase and read in a later one (plain or
  // L2-only loads, never through the read-only cache)
  float* tp;               // (b, n, H)   P1 -> P2
  float* sp;               // (b, n, H)   P1 -> P2
  float* agg;              // (b, n, H)   P3 -> P4
  float* z1;               // (b, n, H)   P4 -> P5, a in place -> P6
  // outputs
  float* h_new;            // (b, n, Ho)
  float* summed;           // (b, n, H)   P2 -> P3
  int b, n, e, d, ho;
  int split;               // warps a target in P2: 1, 2, 4 or 8
  int mid[4];              // P1, P3, P4, P6 use Mid (else Narrow) tiles
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // 16 bytes global -> shared through L2 only; zeros where !valid.
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One product over the rows of all graphs at once, (rows, K) x (K, n_out):
//   out = init + A W^T,  init = bias[c] (times the row's in-degree where
//   `offsets` is set). A's channel k < ka comes from a0, k >= ka from a1
//   (the concatenation [h, agg] of P4); rows of both have stride lda.
//   Output channels c >= n_lo come from a second matrix and go to a second
//   output without bias (P1: [t, s] = h [Wt; Ws]^T + [bt, 0]); a tile never
//   straddles n_lo, a multiple of 32.
struct Product {
  const float* a0;
  const float* a1;
  int ka, lda;
  const float* w;        // (n_lo, ldw)
  const float* w_hi;     // (n_out - n_lo, ldw)
  int ldw, n_lo, n_out, K;
  const float* bias;     // (n_lo,) or null
  const int* offsets;    // (b, n + 1) CSR offsets (P3) or null
  int n;                 // rows of a graph
  float* out;            // (rows, ldo)
  float* out_hi;         // (rows, ldo)
  int ldo, rows;
};

template <class T>
__device__ __forceinline__ void stage_chunk(const Product& o, int r0, int c0,
                                            int kc, float* st) {
  for (int s = threadIdx.x; s < T::kSegs; s += kThreads) {
    const int row = s / (T::kKC / 4), seg = s % (T::kKC / 4);
    const int k = kc * T::kKC + seg * 4;
    if (k >= o.K) continue;
    const float* src;
    bool ok;
    if (row < T::TM) {
      const int r = r0 + row;
      ok = r < o.rows;
      const long long off = static_cast<long long>(ok ? r : 0) * o.lda;
      src = k < o.ka ? o.a0 + off + k : o.a1 + off + (k - o.ka);
    } else {
      int c = c0 + row - T::TM;
      ok = c < o.n_out;
      const float* w = o.w;
      if (c >= o.n_lo) {
        w = o.w_hi;
        c -= o.n_lo;
      }
      src = w + static_cast<long long>(ok ? c : 0) * o.ldw + k;
    }
    cp_async16(st + row * T::LDK + seg * 4, src, ok);
  }
}

__device__ __forceinline__ void product_store(const Product& o, int row,
                                              int col, float sum) {
  if (col >= o.n_lo) {
    o.out_hi[static_cast<long long>(row) * o.ldo + col - o.n_lo] = sum;
    return;
  }
  float v = o.bias != nullptr ? o.bias[col] : 0.f;
  if (o.offsets != nullptr) {
    const int* off = o.offsets + (row / o.n) * (o.n + 1) + row % o.n;
    v *= static_cast<float>(off[1] - off[0]);
  }
  o.out[static_cast<long long>(row) * o.ldo + col] = v + sum;
}

// One product phase: the block's items (blockIdx.x, + gridDim.x, ...) are
// one pipeline of (item, chunk) steps, so the chunks of the next item are
// in flight while this item's last chunks and epilogue run. Every thread of
// the block calls it; it ends on a barrier after which the ring is free.
template <class T>
__device__ void product_phase(const Product& o, float* ring, float* red) {
  constexpr int R = T::kR, G = T::G, LDK = T::LDK;
  const int t = threadIdx.x;
  const int slices = (o.n_out + T::CN - 1) / T::CN;
  const int items = ((o.rows + T::TM - 1) / T::TM) * slices;
  const int nk = (o.K + T::kKC - 1) / T::kKC;
  const int mine = items > static_cast<int>(blockIdx.x)
      ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int steps = mine * nk;
  auto stage = [&](int step) {
    const int item = blockIdx.x + (step / nk) * gridDim.x;
    stage_chunk<T>(o, (item / slices) * T::TM, (item % slices) * T::CN,
                   step % nk, ring + (step % kStages) * T::kStage);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) stage(s);
    cp_async_commit();
  }
  const int g = t / T::kShare, q = t % T::kShare, gy = q / G, gx = q % G;
  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this step's chunk has landed (mine)
    __syncthreads();               // ... everyone's; the last one is consumed
    if (step + kStages - 1 < steps) stage(step + kStages - 1);
    cp_async_commit();
    const float* st = ring + (step % kStages) * T::kStage;
    const int kc = step % nk;
    const int kb = g * T::QK;
    if (kb < o.K - kc * T::kKC) {  // a last chunk may be half full (K = 32m)
#pragma unroll
      for (int k = kb; k < kb + T::QK; k += 4) {
        float4 a[R], w[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          a[i] = *reinterpret_cast<const float4*>(st + (gy + G * i) * LDK + k);
          w[i] = *reinterpret_cast<const float4*>(
              st + (T::TM + gx + G * i) * LDK + k);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int j = 0; j < R; ++j) {
            acc[i][j] = fmaf(a[i].x, w[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, w[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, w[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, w[j].w, acc[i][j]);
          }
        }
      }
    }
    if (kc != nk - 1) continue;
    // Epilogue of the item: its outputs, then fresh accumulators.
    const int item = blockIdx.x + (step / nk) * gridDim.x;
    const int r0 = (item / slices) * T::TM, c0 = (item % slices) * T::CN;
    if (T::kKS > 1) {
      // Partial sums of the depth shares, added in share order. The next
      // write of red is a chunk (and its barrier) away.
      constexpr int kTile = T::TM * T::CN;
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          red[g * kTile + (gy + G * i) * T::CN + gx + G * j] = acc[i][j];
        }
      }
      __syncthreads();
      for (int idx = t; idx < kTile; idx += kThreads) {
        const int row = r0 + idx / T::CN, col = c0 + idx % T::CN;
        if (row < o.rows && col < o.n_out) {
          float v = red[idx];
#pragma unroll
          for (int s = 1; s < T::kKS; ++s) v += red[s * kTile + idx];
          product_store(o, row, col, v);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int row = r0 + gy + G * i, col = c0 + gx + G * j;
          if (row < o.rows && col < o.n_out) product_store(o, row, col, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
    }
  }
  cp_async_wait<0>();  // only empty groups remain
  __syncthreads();
}

__host__ __device__ inline int product_items(bool mid, int rows, int n_out) {
  const int tm = mid ? Mid::TM : Narrow::TM, cn = mid ? Mid::CN : Narrow::CN;
  return ((rows + tm - 1) / tm) * ((n_out + cn - 1) / cn);
}

__device__ __forceinline__ void products(bool mid, const Product& o,
                                         float* ring, float* red) {
  if (mid) {
    product_phase<Mid>(o, ring, red);
  } else {
    product_phase<Narrow>(o, ring, red);
  }
}

// Share `sub` of the stream of target t of graph b: its edges lo + sub,
// lo + sub + split, ... in that order, summed into acc.
template <int CPL>
__device__ __forceinline__ void stream_target(const LayerArgs& p,
                                              const Dropout& dr,
                                              const float* s_wl,
                                              const float (&g)[CPL],
                                              const float (&bt)[CPL],
                                              long long b, int t, int sub,
                                              int lane, float (&acc)[CPL]) {
  constexpr int H = CPL * 32;
  using W = LaneWe<CPL>;
  const int n = p.n, e = p.e, d = p.d;
  const float* sp_b = p.sp + b * n * H;
  const float* ea_b = p.ea + b * e * d;
  const int* perm_b = p.perm + b * e;
  const int* src_b = p.src + b * e;
  const int* off_b = p.offsets + b * (n + 1);
  const int hi = off_b[t + 1];
  const float* wl = s_wl + lane * W::kStride;

  float tr[CPL];
  const float* tp_row = p.tp + (b * n + t) * H;
#pragma unroll
  for (int j = 0; j < CPL; ++j) tr[j] = tp_row[lane + 32 * j];
  for (int i = off_b[t] + sub; i < hi; i += p.split) {  // uniform in the warp
    const int eid = perm_b[i];
    const float* sp_row = sp_b + static_cast<long long>(src_b[i]) * H;
    float z[CPL], a[kMaxD];
#pragma unroll
    for (int j = 0; j < CPL; ++j) z[j] = tr[j] + sp_row[lane + 32 * j];
    load_attr(ea_b + static_cast<long long>(eid) * d, d, a);
    // z = t + s + edge_attr We^T
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) {
      if (k < d) {
#pragma unroll
        for (int j0 = 0; j0 < CPL; j0 += 4) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(wl + k * W::CPL4 + j0);
          const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (j0 + q < CPL) z[j0 + q] = fmaf(a[k], w[q], z[j0 + q]);
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
    mask_factors<CPL>(dr, eid, static_cast<uint32_t>(b), lane, f);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float y = fmaf(fmaf(z[j], rstd, shift), g[j], bt[j]);
      acc[j] += __fdividef(y, 1.f + __expf(-y)) * f[j];
    }
  }
}

// a = silu(LayerNorm(z1) g1 + be1) * node_mask over z1 in place, a warp
// per row of all graphs: every product item of P6 reads the same a.
template <int CPL>
__device__ __forceinline__ void activation_row(const LayerArgs& p,
                                               long long row, int lane) {
  constexpr int H = CPL * 32;
  float* zr = p.z1 + row * H;
  float z[CPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    z[j] = zr[lane + 32 * j];
    s1 += z[j];
    s2 = fmaf(z[j], z[j], s2);
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mu = s1 * (1.f / H);
  const float rstd = rsqrtf(s2 * (1.f / H) - mu * mu + kEps);
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int ch = lane + 32 * j;
    const float y = (z[j] - mu) * rstd * p.g1[ch] + p.be1[ch];
    float a = y / (1.f + expf(-y));
    if (p.node_mask != nullptr) a *= p.node_mask[row * H + ch];
    zr[ch] = a;
  }
}

struct Counts {
  int items[kPhases];  // blocks' work items of each phase
};

__host__ __device__ inline Counts counts(const LayerArgs& p, int hdim) {
  Counts c;
  const int rows = p.b * p.n;
  c.items[0] = product_items(p.mid[0], rows, 2 * hdim);
  const int per_block = kWarps / p.split;
  c.items[1] = (rows + per_block - 1) / per_block;
  c.items[2] = product_items(p.mid[1], rows, hdim);
  c.items[3] = product_items(p.mid[2], rows, hdim);
  c.items[4] = (rows + kWarps - 1) / kWarps;
  c.items[5] = product_items(p.mid[3], rows, p.ho);
  return c;
}

// phase 0: P1 .. P6 with grid barriers (cooperative launch only); 1 .. 6:
// that phase alone.
template <int CPL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_full_fwd_kernel(const LayerArgs p, const int phase) {
  constexpr int H = CPL * 32;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;               // staged chunks; P2: shares and We^T
  float* red = ring + kRingFloats;  // partial sums of a Narrow item
  const int n = p.n, rows = p.b * n;
  const bool all = phase == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (all || phase == 1) {  // P1: [t, s] = h [Wt; Ws]^T + [bt, 0]
    const Product o{p.h, p.h, H, H, p.wt, p.ws, H, H, 2 * H, H, p.bt, nullptr,
                    n, p.tp, p.sp, H, rows};
    products(p.mid[0], o, ring, red);
  }
  if (all) cg::this_grid().sync();

  if (all || phase == 2) {  // P2: the stream
    const Dropout dr{p.seed != nullptr,
                     p.seed ? static_cast<uint32_t>(p.seed[0]) : 0u, p.thr,
                     p.scale, p.graph0};
    using W = LaneWe<CPL>;
    float* part = ring;                 // (kWarps, H) shares
    float* s_wl = ring + kWarps * H;    // We^T per lane
    for (int i = threadIdx.x; i < W::kFloats; i += kThreads) {
      const int l = i / W::kStride, k = i % W::kStride / W::CPL4,
                j = i % W::kStride % W::CPL4;
      s_wl[i] = k < p.d && j < CPL ? p.we[(l + 32 * j) * p.d + k] : 0.f;
    }
    float g[CPL], bt[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      g[j] = p.ge[lane + 32 * j];
      bt[j] = p.be[lane + 32 * j];
    }
    __syncthreads();
    // A block task is kWarps / split targets, `split` warps each; a target's
    // shares are added in share order.
    const int split = p.split, sub = warp % split;
    const int tasks = (rows + kWarps / split - 1) / (kWarps / split);
    for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
      const int tg = task * (kWarps / split) + warp / split;
      const long long b = tg / n;
      const int t = tg % n;
      float acc[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
      if (tg < rows) stream_target<CPL>(p, dr, s_wl, g, bt, b, t, sub, lane, acc);
      if (split > 1) {  // uniform over the launch
#pragma unroll
        for (int j = 0; j < CPL; ++j) part[warp * H + lane + 32 * j] = acc[j];
        __syncthreads();
        if (sub == 0) {
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            for (int s = 1; s < split; ++s) {
              acc[j] += part[(warp + s) * H + lane + 32 * j];
            }
          }
        }
        __syncthreads();
      }
      if (sub == 0 && tg < rows) {
        float* out = p.summed + static_cast<long long>(tg) * H;
#pragma unroll
        for (int j = 0; j < CPL; ++j) out[lane + 32 * j] = acc[j];
      }
    }
  }
  if (all) cg::this_grid().sync();

  if (all || phase == 3) {  // P3: agg = summed Wout^T + deg (x) bout
    const Product o{p.summed, p.summed, H, H, p.wout, p.wout, H, H, H, H,
                    p.bout, p.offsets, n, p.agg, p.agg, H, rows};
    products(p.mid[1], o, ring, red);
  }
  if (all) cg::this_grid().sync();

  if (all || phase == 4) {  // P4: z1 = [h, agg] W1^T + b1
    const Product o{p.h, p.agg, H, H, p.w1, p.w1, 2 * H, H, H, 2 * H, p.b1,
                    nullptr, n, p.z1, p.z1, H, rows};
    products(p.mid[2], o, ring, red);
  }
  if (all) cg::this_grid().sync();

  if (all || phase == 5) {  // P5: a = silu(LN(z1) g1 + be1) * mask
    for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
         row < rows; row += static_cast<long long>(gridDim.x) * kWarps) {
      activation_row<CPL>(p, row, lane);
    }
  }
  if (all) cg::this_grid().sync();

  if (all || phase == 6) {  // P6: h_new = a W2^T + b2
    const Product o{p.z1, p.z1, H, H, p.w2, p.w2, H, p.ho, p.ho, H, p.b2,
                    nullptr, n, p.h_new, p.h_new, p.ho, rows};
    products(p.mid[3], o, ring, red);
  }
}

size_t smem_bytes() { return sizeof(float) * (kRingFloats + kRedFloats); }

constexpr int kMaxDevices = 64;

template <int CPL>
cudaError_t launch(const LayerArgs& p, int cooperative, cudaStream_t stream,
                   int* launches) {
  auto kernel = fused_full_fwd_kernel<CPL>;
  const size_t smem = smem_bytes();
  // Per device, found at the first launch there: the resident grid
  // (resident blocks per SM x SMs), and whether it takes a cooperative
  // launch. Racing first launches write the same values.
  static int resident[kMaxDevices] = {0};
  static bool coop[kMaxDevices] = {false};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int can = 0, per_sm = 0, sms = 0;
    err = cudaDeviceGetAttribute(&can, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    coop[device] = can != 0;
    resident[device] = per_sm * sms;
  }
  // The schedule is a function of the shape and the device only, so both
  // forms compute every item the same way. P2: as many warps a target as
  // the resident grid has for every target, up to a block. Products: Mid
  // tiles where they fill the resident grid at least once, else Narrow.
  LayerArgs q = p;
  const int blocks = resident[device];
  const long long warps = static_cast<long long>(blocks) * kWarps;
  const long long rows = static_cast<long long>(p.b) * p.n;
  q.split = 1;
  for (int s = 2; s <= kWarps; s *= 2) {
    // the shortest chain: ceil(rows * s / warps) rounds of 1/s the edges
    if (((rows * s + warps - 1) / warps) * q.split <
        ((rows * q.split + warps - 1) / warps) * s) {
      q.split = s;
    }
  }
  const int hdim = CPL * 32;
  const int outs[4] = {2 * hdim, hdim, hdim, p.ho};
  for (int i = 0; i < 4; ++i) {
    q.mid[i] = product_items(true, p.b * p.n, outs[i]) >= blocks;
  }
  const Counts cnt = counts(q, hdim);
  if (cooperative > 0 && coop[device]) {
    int most = 0;
    for (int i = 0; i < kPhases; ++i) most = cnt.items[i] > most ? cnt.items[i] : most;
    const int grid = most < blocks ? most : blocks;
    LayerArgs args = q;
    int phase = 0;
    void* params[] = {&args, &phase};
    *launches = 1;
    return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                       dim3(grid), dim3(kThreads), params,
                                       smem, stream);
  }
  for (int i = 0; i < kPhases; ++i) {
    if (cooperative < 0 && i + 1 != -cooperative) continue;
    kernel<<<cnt.items[i], kThreads, smem, stream>>>(q, i + 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// C entry point, loaded with ctypes. Shapes as in LayerArgs above; all
// tensors contiguous float32 (indices int32) on the current device; `w1` is
// the whole (h, 2h) matrix. `h` and the five weight matrices must be 16-byte
// aligned (they are read with 16-byte asynchronous copies). `node_mask` and
// `seed` may be null; `graph0` is the batch index of graph 0 for the edge
// dropout's counter (0 unless the batch is a data-parallel rank's rows).
// `tp`, `sp`, `agg` and `z1` are (b, n, h) scratch, 16-byte aligned. With `cooperative` > 0 and a device that supports it
// the layer is one cooperative launch, else six ordinary launches (one a
// phase); `cooperative` = -k launches phase k alone (to time the phases:
// the outputs are then incomplete). `*launches` receives how many. Launches on `stream` and returns
// the CUDA error code (0 on success).
extern "C" int nbody_fused_full_fwd(
    const float* h, const float* ea, const int* perm, const int* src,
    const int* offsets, const float* wt, const float* bt, const float* ws,
    const float* we, const float* ge, const float* be, const float* wout,
    const float* bout, const float* w1, const float* b1, const float* g1,
    const float* be1, const float* w2, const float* b2,
    const float* node_mask, const int* seed, unsigned int thr, float scale,
    unsigned int graph0, float* tp, float* sp, float* agg, float* z1,
    float* h_new, float* summed,
    int b, int n, int e, int d, int hdim, int ho, int cooperative,
    int* launches, void* stream) {
  *launches = 0;
  if (b < 0 || n < 0 || e < 0 || d < 0 || d > kMaxD || hdim <= 0 ||
      hdim % 32 != 0 || hdim > kMaxH || ho <= 0 || ho > kMaxH ||
      static_cast<long long>(b) * n > (1LL << 29)) {  // item counts in int
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return 0;
  const void* copied[] = {h, wt, ws, wout, w1, w2, tp, sp, agg, z1, summed};
  for (const void* ptr : copied) {
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const LayerArgs p{h, ea, perm, src, offsets, wt, bt, ws, we, ge, be, wout,
                    bout, w1, b1, g1, be1, w2, b2, node_mask, seed, thr,
                    scale, graph0, tp, sp, agg, z1, h_new, summed, b, n, e,
                    d, ho, 1, {0, 0, 0, 0}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (hdim / 32) {
    case 1: err = launch<1>(p, cooperative, s, launches); break;
    case 2: err = launch<2>(p, cooperative, s, launches); break;
    case 3: err = launch<3>(p, cooperative, s, launches); break;
    case 4: err = launch<4>(p, cooperative, s, launches); break;
    case 5: err = launch<5>(p, cooperative, s, launches); break;
    case 6: err = launch<6>(p, cooperative, s, launches); break;
    case 7: err = launch<7>(p, cooperative, s, launches); break;
    case 8: err = launch<8>(p, cooperative, s, launches); break;
  }
  if (err != cudaSuccess) {
    *launches = 0;
    cudaGetLastError();  // clear the sticky launch error
  }
  return static_cast<int>(err);
}
