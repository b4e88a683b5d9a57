// The whole GNN interaction layer as one kernel, for Hopper (sm_90a): the
// kernel, templated on the compute dtype CD, and its launcher. Two libraries
// instantiate it: fused_edge_full.cu (CD = float) and fused_edge_full_bf16.cu
// (CD = __nv_bfloat16, a bfloat16 model's form).
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
// Products of the float32 form. The design before this one (8-row tiles, the
// whole node side of a tile in one block, two phases) took 162 us at B=1 on
// an H100 against a 3 us bound and lost to the composed PyTorch layer: 25 to
// 50 busy SMs, each staging weights with loads nothing overlapped and
// streaming all of them again for every 8 rows. Here a product item is one
// output tile over the rows of all graphs at once (rows of a batch are rows
// of one matrix): 16 x 16 ("Narrow": 416 items in P1 and 208 in P3, P4, P6
// at B=1) or, where there are at least as many such items as resident
// blocks, 32 x 32 ("Mid": B=8 and B=24), which reads half the L2 bytes per
// operation. An item owns its outputs, so no atomics. Its operand rows and
// its weight slice go through shared memory in chunks of 128 (Narrow) or 64
// (Mid) channels, in a ring of three stages filled with 16-byte cp.async.cg
// copies; a block's items are one pipeline of (item, chunk) steps, so the
// next chunks, also those of the next item, are in flight while the FMAs
// run. A thread holds a 4 x 4 block of outputs (with 2 x 2 blocks, four
// 16-byte shared-memory reads per 16 FMAs bound the products), and the depth
// of a chunk is split 16 (Narrow) or 4 (Mid) ways between groups of threads,
// whose partial sums are added in a fixed order. Rows of a staged chunk are
// padded (132 or 68 floats) so eight neighbouring rows fall in distinct
// banks. Float32 FMAs only (TF32 does not hold the tests' 1e-5).
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
// No float atomics; every sum is taken in a fixed order (a tensor-core
// product's too), so reruns are bit-identical.
//
// The bf16 form (CD = __nv_bfloat16): the TPU kernel with cd = bfloat16,
// every product on bf16 operands with a float32 sum, rounded where that
// kernel rounds: t = bf16(bf16(sum) + bf16(bt)) and s = bf16(sum), kept as
// float32 holding bf16 values (so P2 reads them as it reads the float32
// form's); P2 rounds each edge's term to bf16 after dropout's scale, summed
// stays float32 (kernel 1's bf16 form); agg = sum + deg bout unrounded;
// z1 = bf16(bf16(sum) + bf16(b1)); P5 in float32; h_new = bf16(bf16(sum) +
// bf16(b2)), as float32. Its four products run on the bf16 tensor cores
// (mma.sync m16n8k16, bf16 x bf16 -> float32), as the TPU kernel's run on
// its matrix unit:
//   - Operands are bf16 in memory and in shared memory, copied with
//     cp.async and read with ldmatrix; each phase that writes an operand a
//     later product reads writes it in bf16 beside (or instead of) its
//     float32 result: P1 the bf16 rows of h (the items of column slice 0,
//     from the rows they staged) for P4, P2 bf16(summed) for P3, P3
//     bf16(agg) (the only form P4 reads), P5 bf16(a) for P6. wt and ws
//     arrive in bf16; P1's blocks convert Wout, W1 and W2 once a launch
//     into bf16 scratch, after their products and before the first grid
//     barrier. h (float32, the layer's input) is the one operand converted
//     while staging: P1 loads its rows into registers when it starts a
//     chunk's copies and converts and stores them after the current
//     step's products, so the loads overlap the tensor cores.
//   - An item is a 64 x 64 output tile (Tc: eight warps of 16 x 32, each
//     summing every channel of its share in order, 64-channel chunks), in
//     every product and at every row count; rows and outputs past the
//     matrix are masked. The form runs only in training (a bf16 model's
//     inference rebuilds it at float32), where B N is thousands of rows.
//     Staged rows are padded by 16 bytes, so the eight rows an ldmatrix
//     phase reads fall in distinct banks; the stage ring holds bf16, half
//     the float32 form's bytes a channel.
//
// Bound on an H100 at the serving shape (B=1, N=200, k=40, E=8000, H=Ho=256,
// D=5): 2*N*H*(5H+Ho) = 157 MFLOP of products plus the stream's 23*E*H =
// 47 MFLOP, 3.0 us at 67 TFLOP/s float32 outside the tensor cores; against
// 2.5 MB (h, h_new, summed, edge_attr, the CSR and 1.5 MB of weights), 0.75
// us at 3.35 TB/s. Bound by operations. The bf16 form's products at the
// bf16 tensor-core rate (989 TFLOP/s) leave the stream's float32 work: 0.87
// us at B=1, 21.6 us at B=24 training. What the float32 design pays beyond
// its bound (measured on an H100 80GB HBM3 at 700 W, each phase as its own
// launch): at B=1 the stream (~15 us: chains of ~5 dependent edges) and five
// grid barriers; at B=24 (training) the stream, ~160 us at ~1 ns an edge,
// and the products, ~200 us at ~18 TFLOP/s. Times on the card are in
// PERF.md (chip_smoke.py phases 3 and 15).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

using bf16 = __nv_bfloat16;

// The bf16 form's product item: a 64 x 64 output tile on the tensor cores,
// a warp of the block's 4 x 2 grid a 16 x 32 share (four m16n8k16 products
// a 16-channel step), through staged chunks of 64 channels. Every row and
// output past the matrix is masked, so it serves any row count.
struct Tc {
  static constexpr int kWM = 4, kWN = 2, kNT = 4, kKC = 64;
  static constexpr int TM = 16 * kWM, CN = 8 * kNT * kWN;  // rows, outputs
  static constexpr int LDK = kKC + 8;  // bf16: rows 16 bytes off in banks
  static constexpr int kStage = (TM + CN) * LDK;       // bf16
  static constexpr int kSegs = (TM + CN) * (kKC / 8);  // 16-byte copies
  static constexpr int kASegs = TM * (kKC / 8) / kThreads;  // float32 A
  static_assert(kWM * kWN == kWarps, "a warp per 16 x 8NT share");
  static_assert(kNT % 2 == 0 && kKC % 16 == 0, "ldmatrix.x4 B, k16 steps");
  static_assert(TM * (kKC / 8) % kThreads == 0, "A segments a thread");
};

// Shared memory of each form, in floats: the ring (staged chunks; P2's
// shares and We^T) and, behind it, the partial sums of a depth-split item
// (the float32 form's; the bf16 form's items sum in one warp).
template <class CD>
struct Smem {
  static constexpr int kRing = kRingFloats, kRed = kRedFloats;
};
template <>
struct Smem<bf16> {
  static constexpr int kRing = kStages * Tc::kStage / 2, kRed = 0;
};
static_assert(Smem<float>::kRing >= kWarps * kMaxH +
                                        32 * (kMaxD * kMaxH / 32 + 4) &&
                  Smem<bf16>::kRing >= kWarps * kMaxH +
                                           32 * (kMaxD * kMaxH / 32 + 4),
              "P2 shares and We^T fit in the ring");

// The compute dtype CD: float, or __nv_bfloat16 for the bf16 form.
template <class CD>
constexpr bool kBf16 = !std::is_same<CD, float>::value;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct LayerArgs {
  // inputs
  const float* h;          // (b, n, H)
  const float* ea;         // (b, e, d)
  const int* perm;         // (b, e) edge ids sorted by target
  const int* src;          // (b, e) source of each sorted edge
  const int* offsets;      // (b, n + 1)
  const float* wt;         // (H, H)   edge_proj_target.weight (float32 form)
  const float* bt;         // (H,)
  const float* ws;         // (H, H)   edge_proj_source.weight (float32 form)
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
  float* agg;              // (b, n, H)   P3 -> P4 (float32 form)
  float* z1;               // (b, n, H)   P4 -> P5 (float32 form: a in
                           //             place -> P6)
  // outputs
  float* h_new;            // (b, n, Ho)
  float* summed;           // (b, n, H)   P2 -> P3
  int b, n, e, d, ho;
  int split;               // warps a target in P2: 1, 2, 4 or 8
  int mid[4];              // float32 form: P1, P3, P4, P6 use Mid tiles
  // the bf16 form: wt and ws in bf16, and the bf16 operands the phases
  // hand on
  const bf16* wt16;        // (H, H)
  const bf16* ws16;        // (H, H)
  bf16* hb;                // (b, n, H)   bf16(h): P1 -> P4
  bf16* sb;                // (b, n, H)   bf16(summed): P2 -> P3
  bf16* aggb;              // (b, n, H)   bf16(agg): P3 -> P4
  bf16* ab;                // (b, n, H)   bf16(a): P5 -> P6
  bf16* wout16;            // (H, H)      P1 (converted) -> P3
  bf16* w1_16;             // (H, 2H)     P1 -> P4
  bf16* w2_16;             // (Ho, H)     P1 -> P6
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// An output of a float32 product.
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
    const int kc = step % nk;
    __syncthreads();               // ... everyone's; the last one is consumed
    if (step + kStages - 1 < steps) stage(step + kStages - 1);
    cp_async_commit();
    const float* st = ring + (step % kStages) * T::kStage;
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
          if (row < o.rows && col < o.n_out) {
            product_store(o, row, col, acc[i][j]);
          }
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

// One product of the bf16 form over the rows of all graphs at once, as
// Product, on the tensor cores: bf16 operands, float32 sums, the outputs
// rounded where the TPU kernel rounds them (tc_store). A's channel k < ka
// comes from a0, k >= ka from a1, both bf16 and of row stride lda; or, with
// a float32 A (P1's h), every channel from a0, converted while staging, and
// the items of column slice 0 write the bf16 rows they staged to a_copy
// (stride lda). out is bf16 where out16 (P3's agg), else float32.
struct TcProduct {
  const void* a0;
  const bf16* a1;
  int ka, lda;
  const bf16* w;         // (n_lo, ldw)
  const bf16* w_hi;      // (n_out - n_lo, ldw)
  int ldw, n_lo, n_out, K;
  const float* bias;     // (n_lo,)
  const int* offsets;    // (b, n + 1) CSR offsets (P3) or null
  int n;                 // rows of a graph
  void* out;             // (rows, ldo)
  float* out_hi;         // (rows, ldo)
  bool out16;
  int ldo, rows;
  bf16* a_copy;          // float32 A: its bf16 rows, or null
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a b: a 16 x 16 bf16 A fragment, a 16 x 8 bf16 B fragment (b0, b1),
// a 16 x 8 float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Row `row`'s factor of P3's bias: its in-degree (1 for the other
// products).
__device__ __forceinline__ float tc_row_scale(const TcProduct& o, int row) {
  if (o.offsets == nullptr || row >= o.rows) return 1.f;
  const int* off = o.offsets + (row / o.n) * (o.n + 1) + row % o.n;
  return static_cast<float>(off[1] - off[0]);
}

// Outputs (row, col) and (row, col + 1) of a bf16 product, col even: the
// second matrix's output (s) bf16(sum), a biased output bf16(bf16(sum) +
// bf16(bias)), P3's sum + deg bout unrounded (stored in bf16: P4 reads
// nothing else of it). One 8-byte (4-byte in bf16) store where both lie in
// one output and its rows have an even stride.
__device__ __forceinline__ void tc_store(const TcProduct& o, int row, int col,
                                         float v0, float v1, float deg) {
  if (row >= o.rows || col >= o.n_out) return;
  const long long at = static_cast<long long>(row) * o.ldo;
  const bool pair = col + 1 < o.n_out && (o.ldo & 1) == 0;
  if (col >= o.n_lo) {
    float* out = o.out_hi + at + col - o.n_lo;
    v0 = round_bf16(v0);
    v1 = round_bf16(v1);
    if (pair) {
      *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
    } else {
      out[0] = v0;
      if (col + 1 < o.n_out) out[1] = v1;
    }
    return;
  }
  const float b0 = o.bias[col], b1 = col + 1 < o.n_out ? o.bias[col + 1] : 0.f;
  if (o.offsets != nullptr) {
    v0 += b0 * deg;
    v1 += b1 * deg;
  } else {
    v0 = round_bf16(round_bf16(v0) + round_bf16(b0));
    v1 = round_bf16(round_bf16(v1) + round_bf16(b1));
  }
  if (o.out16) {
    bf16* out = static_cast<bf16*>(o.out) + at + col;
    if (pair) {
      *reinterpret_cast<uint32_t*>(out) = pack_bf16(v0, v1);
    } else {
      out[0] = __float2bfloat16_rn(v0);
      if (col + 1 < o.n_out) out[1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* out = static_cast<float*>(o.out) + at + col;
    if (pair) {
      *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
    } else {
      out[0] = v0;
      if (col + 1 < o.n_out) out[1] = v1;
    }
  }
}

// One bf16 product phase, product_phase's pipeline on the tensor cores: the
// block's items (blockIdx.x, + gridDim.x, ...) are one pipeline of (item,
// chunk) steps through a ring of kStages bf16 stages. A float32 A (AF) is
// loaded into registers when its step's copies start and converted and
// stored after the current step's products. Warp (wm, wn) sums rows
// 16 wm .. + 16 and outputs 8 NT wn .. + 8 NT of the tile over every
// channel, in channel order. Every thread of the block calls it; it ends on
// a barrier after which the ring is free.
template <bool AF>
__device__ void tc_product_phase(const TcProduct& o, bf16* ring) {
  constexpr int TM = Tc::TM, CN = Tc::CN, KC = Tc::kKC, LDK = Tc::LDK;
  constexpr int NT = Tc::kNT;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int slices = (o.n_out + CN - 1) / CN;
  const int items = ((o.rows + TM - 1) / TM) * slices;
  const int nk = (o.K + KC - 1) / KC;
  const int mine = items > static_cast<int>(blockIdx.x)
      ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int steps = mine * nk;
  float4 pre[AF ? 2 * Tc::kASegs : 1];  // AF: the next A segments, float32
  auto start = [&](int step) {  // the copies of step's chunk
    const int item = blockIdx.x + (step / nk) * gridDim.x, kc = step % nk;
    const int r0 = (item / slices) * TM, c0 = (item % slices) * CN;
    bf16* st = ring + (step % kStages) * Tc::kStage;
    for (int s = (AF ? TM * (KC / 8) : 0) + t; s < Tc::kSegs; s += kThreads) {
      const int row = s / (KC / 8), seg = s % (KC / 8);
      const int k = kc * KC + seg * 8;
      if (k >= o.K) continue;
      const bf16* src;
      bool ok;
      if (row < TM) {
        const int r = r0 + row;
        ok = r < o.rows;
        const long long off = static_cast<long long>(ok ? r : 0) * o.lda;
        src = k < o.ka ? static_cast<const bf16*>(o.a0) + off + k
                       : o.a1 + off + (k - o.ka);
      } else {
        int c = c0 + row - TM;
        ok = c < o.n_out;
        const bf16* w = o.w;
        if (c >= o.n_lo) {
          w = o.w_hi;
          c -= o.n_lo;
        }
        src = w + static_cast<long long>(ok ? c : 0) * o.ldw + k;
      }
      cp_async16(st + row * LDK + seg * 8, src, ok);
    }
    if constexpr (AF) {
#pragma unroll
      for (int i = 0; i < Tc::kASegs; ++i) {
        const int s = t + i * kThreads;
        const int r = r0 + s / (KC / 8), k = kc * KC + (s % (KC / 8)) * 8;
        if (r < o.rows && k < o.K) {
          const float4* src = reinterpret_cast<const float4*>(
              static_cast<const float*>(o.a0) +
              static_cast<long long>(r) * o.lda + k);
          pre[2 * i] = __ldg(src);
          pre[2 * i + 1] = __ldg(src + 1);
        } else {
          pre[2 * i] = pre[2 * i + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  };
  auto land = [&](int step) {  // AF: convert and store step's A segments
    if constexpr (AF) {
      const int item = blockIdx.x + (step / nk) * gridDim.x, kc = step % nk;
      const int r0 = (item / slices) * TM, c0 = (item % slices) * CN;
      bf16* st = ring + (step % kStages) * Tc::kStage;
#pragma unroll
      for (int i = 0; i < Tc::kASegs; ++i) {
        const int s = t + i * kThreads;
        const int row = s / (KC / 8), seg = s % (KC / 8);
        const float4 x = pre[2 * i], y = pre[2 * i + 1];
        const uint4 v = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                                   pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
        *reinterpret_cast<uint4*>(st + row * LDK + seg * 8) = v;
        const int r = r0 + row, k = kc * KC + seg * 8;
        if (c0 == 0 && o.a_copy != nullptr && r < o.rows && k < o.K) {
          *reinterpret_cast<uint4*>(
              o.a_copy + static_cast<long long>(r) * o.lda + k) = v;
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      start(s);
      land(s);
    }
    cp_async_commit();
  }
  const int wm = warp / Tc::kWN, wn = warp % Tc::kWN;
  // ldmatrix rows of this lane: A's (16 x 16 a step), and W's (two n8
  // blocks, both 8-channel halves, a step).
  const int a_row = 16 * wm + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = TM + wn * 8 * NT + (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this step's chunk has landed (mine)
    __syncthreads();               // ... everyone's; the last one is consumed
    const bool ahead = step + kStages - 1 < steps;
    if (ahead) start(step + kStages - 1);
    cp_async_commit();
    const int kc = step % nk;
    const bf16* st = ring + (step % kStages) * Tc::kStage;
    const int valid = o.K - kc * KC;  // a last chunk may be part full
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      if (kk < valid) {  // uniform in the block
        uint32_t a[4];
        ldmatrix_x4(a, st + a_row * LDK + kk + a_col);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t w[4];
          ldmatrix_x4(w, st + (b_row + 16 * np) * LDK + kk + b_col);
          mma_bf16(acc[2 * np], a, w[0], w[1]);
          mma_bf16(acc[2 * np + 1], a, w[2], w[3]);
        }
      }
    }
    if (ahead) land(step + kStages - 1);
    if (kc != nk - 1) continue;
    // Epilogue of the item: its outputs, then fresh accumulators. Lane
    // (4 q + u) holds rows q, q + 8 and columns 2u, 2u + 1 of each n8 block.
    const int item = blockIdx.x + (step / nk) * gridDim.x;
    const int r0 = (item / slices) * TM + 16 * wm + (lane >> 2);
    const int c0 = (item % slices) * CN + wn * 8 * NT + 2 * (lane & 3);
    const float deg[2] = {tc_row_scale(o, r0), tc_row_scale(o, r0 + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tc_store(o, r0 + 8 * h, c0 + 8 * j, acc[j][2 * h], acc[j][2 * h + 1],
                 deg[h]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
  }
  cp_async_wait<0>();  // only empty groups remain
  __syncthreads();
}

__host__ __device__ inline int tc_items(int rows, int n_out) {
  return ((rows + Tc::TM - 1) / Tc::TM) * ((n_out + Tc::CN - 1) / Tc::CN);
}

// The bf16 form's weights that arrive in float32 (Wout, W1, W2), converted
// once a launch into bf16 scratch by every block of P1.
__device__ void weights_to_bf16(const LayerArgs& p, int hdim) {
  const long long n1 = static_cast<long long>(hdim) * hdim / 4;
  const long long n2 = 3 * n1, n3 = n2 + static_cast<long long>(p.ho) * hdim / 4;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n3; i += static_cast<long long>(gridDim.x) * kThreads) {
    const float* src = p.wout;
    bf16* dst = p.wout16;
    long long j = i;
    if (i >= n2) {
      src = p.w2;
      dst = p.w2_16;
      j = i - n2;
    } else if (i >= n1) {
      src = p.w1;
      dst = p.w1_16;
      j = i - n1;
    }
    const float4 v = reinterpret_cast<const float4*>(src)[j];
    *reinterpret_cast<uint2*>(dst + 4 * j) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// Share `sub` of the stream of target t of graph b: its edges lo + sub,
// lo + sub + split, ... in that order, summed into acc; the bf16 form
// rounds each term to bf16 after dropout's scale.
template <int CPL, class CD>
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
      if constexpr (kBf16<CD>) {
        acc[j] += round_bf16(__fdividef(y, 1.f + __expf(-y)) * f[j]);
      } else {
        acc[j] += __fdividef(y, 1.f + __expf(-y)) * f[j];
      }
    }
  }
}

// a = silu(LayerNorm(z1) g1 + be1) * node_mask over z1 in place (the bf16
// form: bf16(a) into ab), a warp per row of all graphs: every product item
// of P6 reads the same a.
template <int CPL, class CD>
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
    if constexpr (kBf16<CD>) {
      p.ab[row * H + ch] = __float2bfloat16_rn(a);
    } else {
      zr[ch] = a;
    }
  }
}

struct Counts {
  int items[kPhases];  // blocks' work items of each phase
};

template <class CD>
Counts counts(const LayerArgs& p, int hdim) {
  Counts c;
  const int rows = p.b * p.n;
  const int outs[4] = {2 * hdim, hdim, hdim, p.ho};
  const int at[4] = {0, 2, 3, 5};  // the product phases
  for (int i = 0; i < 4; ++i) {
    c.items[at[i]] = kBf16<CD> ? tc_items(rows, outs[i])
                               : product_items(p.mid[i], rows, outs[i]);
  }
  const int per_block = kWarps / p.split;
  c.items[1] = (rows + per_block - 1) / per_block;
  c.items[4] = (rows + kWarps - 1) / kWarps;
  return c;
}

// phase 0: P1 .. P6 with grid barriers (cooperative launch only); 1 .. 6:
// that phase alone.
template <int CPL, class CD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_full_fwd_kernel(const LayerArgs p, const int phase) {
  constexpr int H = CPL * 32;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;  // staged chunks; P2: shares and We^T
  float* red = ring + Smem<CD>::kRing;  // float32 form: a split item's sums
  bf16* ring16 = reinterpret_cast<bf16*>(ring);  // the bf16 form's stages
  const int n = p.n, rows = p.b * n;
  const bool all = phase == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (all || phase == 1) {  // P1: [t, s] = h [Wt; Ws]^T + [bt, 0]
    if constexpr (kBf16<CD>) {
      const TcProduct o{p.h, nullptr, H, H, p.wt16, p.ws16, H, H, 2 * H, H,
                        p.bt, nullptr, n, p.tp, p.sp, false, H, rows, p.hb};
      tc_product_phase<true>(o, ring16);
      weights_to_bf16(p, H);
    } else {
      const Product o{p.h, p.h, H, H, p.wt, p.ws, H, H, 2 * H, H, p.bt,
                      nullptr, n, p.tp, p.sp, H, rows};
      products(p.mid[0], o, ring, red);
    }
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
      if (tg < rows) {
        stream_target<CPL, CD>(p, dr, s_wl, g, bt, b, t, sub, lane, acc);
      }
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
        if constexpr (kBf16<CD>) {
          bf16* out16 = p.sb + static_cast<long long>(tg) * H;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            out16[lane + 32 * j] = __float2bfloat16_rn(acc[j]);
          }
        }
      }
    }
  }
  if (all) cg::this_grid().sync();

  if (all || phase == 3) {  // P3: agg = summed Wout^T + deg (x) bout
    if constexpr (kBf16<CD>) {
      const TcProduct o{p.sb, p.sb, H, H, p.wout16, p.wout16, H, H, H, H,
                        p.bout, p.offsets, n, p.aggb, nullptr, true, H, rows,
                        nullptr};
      tc_product_phase<false>(o, ring16);
    } else {
      const Product o{p.summed, p.summed, H, H, p.wout, p.wout, H, H, H, H,
                      p.bout, p.offsets, n, p.agg, p.agg, H, rows};
      products(p.mid[1], o, ring, red);
    }
  }
  if (all) cg::this_grid().sync();

  if (all || phase == 4) {  // P4: z1 = [h, agg] W1^T + b1
    if constexpr (kBf16<CD>) {
      const TcProduct o{p.hb, p.aggb, H, H, p.w1_16, p.w1_16, 2 * H, H, H,
                        2 * H, p.b1, nullptr, n, p.z1, nullptr, false, H,
                        rows, nullptr};
      tc_product_phase<false>(o, ring16);
    } else {
      const Product o{p.h, p.agg, H, H, p.w1, p.w1, 2 * H, H, H, 2 * H, p.b1,
                      nullptr, n, p.z1, p.z1, H, rows};
      products(p.mid[2], o, ring, red);
    }
  }
  if (all) cg::this_grid().sync();

  if (all || phase == 5) {  // P5: a = silu(LN(z1) g1 + be1) * mask
    for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
         row < rows; row += static_cast<long long>(gridDim.x) * kWarps) {
      activation_row<CPL, CD>(p, row, lane);
    }
  }
  if (all) cg::this_grid().sync();

  if (all || phase == 6) {  // P6: h_new = a W2^T + b2
    if constexpr (kBf16<CD>) {
      const TcProduct o{p.ab, p.ab, H, H, p.w2_16, p.w2_16, H, p.ho, p.ho, H,
                        p.b2, nullptr, n, p.h_new, nullptr, false, p.ho, rows,
                        nullptr};
      tc_product_phase<false>(o, ring16);
    } else {
      const Product o{p.z1, p.z1, H, H, p.w2, p.w2, H, p.ho, p.ho, H, p.b2,
                      nullptr, n, p.h_new, p.h_new, p.ho, rows};
      products(p.mid[3], o, ring, red);
    }
  }
}

template <class CD>
size_t smem_bytes() {
  return sizeof(float) * (Smem<CD>::kRing + Smem<CD>::kRed);
}

constexpr int kMaxDevices = 64;

template <int CPL, class CD>
cudaError_t launch(const LayerArgs& p, int cooperative, cudaStream_t stream,
                   int* launches) {
  auto kernel = fused_full_fwd_kernel<CPL, CD>;
  const size_t smem = smem_bytes<CD>();
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
  // the resident grid has for every target, up to a block. The float32
  // form's products: Mid tiles where they fill the resident grid at least
  // once, else Narrow; the bf16 form's are Tc tiles.
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
  for (int i = 0; i < 4 && !kBf16<CD>; ++i) {
    q.mid[i] = product_items(true, p.b * p.n, outs[i]) >= blocks;
  }
  const Counts cnt = counts<CD>(q, hdim);
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

// The C entry points' body (fused_edge_full.cu, fused_edge_full_bf16.cu).
// Shapes as in LayerArgs above; all tensors contiguous float32 (indices
// int32) on the current device, but for the bf16 form's `wt` and `ws`
// (bf16); `w1` is the whole (h, 2h) matrix. `h` and the five weight
// matrices must be 16-byte aligned (they are read 16 bytes at a time).
// `node_mask` and `seed` may be null; `graph0` is the batch index of graph
// 0 for the edge dropout's counter (0 unless the batch is a data-parallel
// rank's rows). `tp`, `sp` and `z1` are (b, n, h) float32 scratch, 16-byte
// aligned; `agg` is (b, n, h) float32 scratch in the float32 form and, in
// the bf16 form, bf16 scratch of 4 b n h + h (3 h + ho) elements (the bf16
// operands of LayerArgs, in its order), 16-byte aligned. With
// `cooperative` > 0 and a device that supports it the layer is one
// cooperative launch, else six ordinary launches (one a phase);
// `cooperative` = -k launches phase k alone (to time the phases: the
// outputs are then incomplete). `*launches` receives how many. Launches on
// `stream` and returns the CUDA error code (0 on success).
template <class CD>
int run(const float* h, const float* ea, const int* perm, const int* src,
        const int* offsets, const void* wt, const float* bt, const void* ws,
        const float* we, const float* ge, const float* be, const float* wout,
        const float* bout, const float* w1, const float* b1, const float* g1,
        const float* be1, const float* w2, const float* b2,
        const float* node_mask, const int* seed, unsigned int thr,
        float scale, unsigned int graph0, float* tp, float* sp, void* agg,
        float* z1, float* h_new, float* summed, int b, int n, int e, int d,
        int hdim, int ho, int cooperative, int* launches, void* stream) {
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
  LayerArgs p{};
  p.h = h;
  p.ea = ea;
  p.perm = perm;
  p.src = src;
  p.offsets = offsets;
  p.bt = bt;
  p.we = we;
  p.ge = ge;
  p.be = be;
  p.wout = wout;
  p.bout = bout;
  p.w1 = w1;
  p.b1 = b1;
  p.g1 = g1;
  p.be1 = be1;
  p.w2 = w2;
  p.b2 = b2;
  p.node_mask = node_mask;
  p.seed = seed;
  p.thr = thr;
  p.scale = scale;
  p.graph0 = graph0;
  p.tp = tp;
  p.sp = sp;
  p.z1 = z1;
  p.h_new = h_new;
  p.summed = summed;
  p.b = b;
  p.n = n;
  p.e = e;
  p.d = d;
  p.ho = ho;
  p.split = 1;
  if (kBf16<CD>) {
    const long long plane = static_cast<long long>(b) * n * hdim;
    p.wt16 = static_cast<const bf16*>(wt);
    p.ws16 = static_cast<const bf16*>(ws);
    p.hb = static_cast<bf16*>(agg);
    p.sb = p.hb + plane;
    p.aggb = p.sb + plane;
    p.ab = p.aggb + plane;
    p.wout16 = p.ab + plane;
    p.w1_16 = p.wout16 + static_cast<long long>(hdim) * hdim;
    p.w2_16 = p.w1_16 + 2LL * hdim * hdim;
  } else {
    p.wt = static_cast<const float*>(wt);
    p.ws = static_cast<const float*>(ws);
    p.agg = static_cast<float*>(agg);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (hdim / 32) {
    case 1: err = launch<1, CD>(p, cooperative, s, launches); break;
    case 2: err = launch<2, CD>(p, cooperative, s, launches); break;
    case 3: err = launch<3, CD>(p, cooperative, s, launches); break;
    case 4: err = launch<4, CD>(p, cooperative, s, launches); break;
    case 5: err = launch<5, CD>(p, cooperative, s, launches); break;
    case 6: err = launch<6, CD>(p, cooperative, s, launches); break;
    case 7: err = launch<7, CD>(p, cooperative, s, launches); break;
    case 8: err = launch<8, CD>(p, cooperative, s, launches); break;
  }
  if (err != cudaSuccess) {
    *launches = 0;
    cudaGetLastError();  // clear the sticky launch error
  }
  return static_cast<int>(err);
}

}  // namespace
