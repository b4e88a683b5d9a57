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
// order, and the only dependence that crosses rows is that the stream of a
// target reads s of arbitrary sources. So the kernel has two phases around
// one grid-wide barrier:
//
//   A. items (graph, tile of 8 rows, which of t / s): one (8, H) x (H, H)
//      product each, written to a global scratch (2 * N * H floats a graph,
//      which stays in the L2 cache);
//   -- grid.sync() --
//   B. items (graph, tile of 8 target rows): the stream with one warp per
//      target (its edges in CSR order, accumulated in registers), then the
//      four node-side products, the LayerNorm and the SiLU on the tile in
//      shared memory. Nothing of the tile but h_new and summed leaves the SM.
//
// It is launched cooperatively (cudaLaunchCooperativeKernel) with a
// persistent grid of at most (resident blocks per SM) x (SMs) blocks that
// loop over the items, so any batch fits: one launch per layer. Where the
// device reports no cooperative launch, or the caller asks for it, the two
// phases run as two ordinary launches of the same kernel instead.
//
// The six products are in this kernel's own body: float32 FMA, a thread per
// output channel and 8 rows per thread, the (8, H) operand tile broadcast
// from shared memory and the weights staged through shared memory 32 input
// channels at a time (read coalesced along the input dimension and stored
// transposed, padded against bank conflicts). No float atomics; every sum is
// taken in a fixed order, so reruns are bit-identical.
//
// Bound on an H100 at the serving shape (B=1, N=200, k=40, E=8000, H=Ho=256,
// D=5): 2*N*H*(5H+Ho) = 157 MFLOP of products plus the stream's 23*E*H =
// 47 MFLOP, 3.0 us at 67 TFLOP/s float32 outside the tensor cores; against
// 2.5 MB (h, h_new, summed, edge_attr, the CSR and 1.5 MB of weights), 0.75
// us at 3.35 TB/s. Bound by operations. What the design pays beyond the
// bound: every row tile streams the four node-side matrices (1 MB) from L2
// again, 25 tiles a graph, and at B=1 only 25 to 50 of the 132 SMs have
// work. Larger row tiles, tensor cores (TF32 does not hold the tests'
// 1e-5) and overlapping the weight loads with the FMAs are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_stream.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nbody_edge;

constexpr int kTM = kWarps;       // rows of a tile: one warp per target row
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;           // input channels of a staged weight chunk
constexpr int kLdw = kMaxH + 1;   // padded row of the staged chunk

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
  // scratch, written in phase A and read in phase B: never through the
  // read-only cache
  float* tp;               // (b, n, H)
  float* sp;               // (b, n, H)
  // outputs
  float* h_new;            // (b, n, Ho)
  float* summed;           // (b, n, H)
  int b, n, e, d, ho;
};

// acc[r] += sum_k s_a[r * H + k] * w[c * ldw + k] for this thread's output
// channel c = threadIdx.x (idle where c >= n_out) and the tile's kTM rows.
// `w` is (n_out, >= H) row-major with row stride ldw. Every thread of the
// block must call it; s_w is the (kBK, kLdw) staging buffer.
template <int H>
__device__ __forceinline__ void tile_product(float (&acc)[kTM],
                                             const float* s_a,
                                             const float* __restrict__ w,
                                             int ldw, int n_out, float* s_w) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = threadIdx.x;
  for (int k0 = 0; k0 < H; k0 += kBK) {
    // Warp w stages channels 32w .. 32w+31; a lane reads one input channel,
    // so each row is one coalesced 128-byte read.
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const int cc = warp * 32 + i;
      const float v = cc < n_out
          ? w[static_cast<long long>(cc) * ldw + k0 + lane] : 0.f;
      s_w[lane * kLdw + cc] = v;
    }
    __syncthreads();
    if (c < n_out) {
#pragma unroll
      for (int k = 0; k < kBK; k += 4) {
        const float w0 = s_w[(k + 0) * kLdw + c];
        const float w1 = s_w[(k + 1) * kLdw + c];
        const float w2 = s_w[(k + 2) * kLdw + c];
        const float w3 = s_w[(k + 3) * kLdw + c];
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          const float4 a =
              *reinterpret_cast<const float4*>(s_a + r * H + k0 + k);
          acc[r] = fmaf(a.x, w0, acc[r]);
          acc[r] = fmaf(a.y, w1, acc[r]);
          acc[r] = fmaf(a.z, w2, acc[r]);
          acc[r] = fmaf(a.w, w3, acc[r]);
        }
      }
    }
    __syncthreads();
  }
}

// Rows r0 .. r0+kTM-1 of the (n, H) matrix `x` into the tile s_x, zeros
// beyond row n.
template <int H>
__device__ __forceinline__ void load_tile(const float* x, int r0, int n,
                                          float* s_x) {
  for (int i = threadIdx.x; i < kTM * H; i += kThreads) {
    const int r = r0 + i / H;
    s_x[i] = r < n ? x[static_cast<long long>(r0) * H + i] : 0.f;
  }
}

// phase 0: A, grid barrier, B (cooperative launch only); 1: A; 2: B.
template <int CPL>
__global__ void __launch_bounds__(kThreads)
fused_full_fwd_kernel(const LayerArgs p, const int phase) {
  constexpr int H = CPL * 32;
  extern __shared__ __align__(16) float smem[];
  float* s_x0 = smem;                // the tile of h
  float* s_x1 = s_x0 + kTM * H;      // summed, then z1 and a
  float* s_x2 = s_x1 + kTM * H;      // agg
  float* s_w = s_x2 + kTM * H;       // staged weight chunk
  float* s_we = s_w + kBK * kLdw;    // We transposed to (d, H)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = threadIdx.x;
  const int n = p.n, e = p.e, d = p.d;
  const int tiles = (n + kTM - 1) / kTM;

  if (phase != 2) {
    const int items = p.b * tiles * 2;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int which = item & 1;  // 0: t, 1: s
      const int tile = (item >> 1) % tiles;
      const long long b = (item >> 1) / tiles;
      const int r0 = tile * kTM;
      load_tile<H>(p.h + b * n * H, r0, n, s_x0);
      __syncthreads();
      float acc[kTM];
      const float bias = (which == 0 && c < H) ? p.bt[c] : 0.f;
#pragma unroll
      for (int r = 0; r < kTM; ++r) acc[r] = bias;
      tile_product<H>(acc, s_x0, which == 0 ? p.wt : p.ws, H, H, s_w);
      float* out = (which == 0 ? p.tp : p.sp) + b * n * H;
      if (c < H) {
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          if (r0 + r < n) out[static_cast<long long>(r0 + r) * H + c] = acc[r];
        }
      }
      // tile_product ends on a barrier: s_x0 is free for the next item.
    }
  }

  if (phase == 0) cg::this_grid().sync();

  if (phase != 1) {
    const Dropout dr{p.seed != nullptr,
                     p.seed ? static_cast<uint32_t>(p.seed[0]) : 0u, p.thr,
                     p.scale};
    for (int i = threadIdx.x; i < d * H; i += kThreads) {
      s_we[i] = p.we[(i % H) * d + i / H];  // (H, d) -> (d, H)
    }
    float g[CPL], bt[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      g[j] = p.ge[lane + 32 * j];
      bt[j] = p.be[lane + 32 * j];
    }
    __syncthreads();

    const int items = p.b * tiles;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int tile = item % tiles;
      const long long b = item / tiles;
      const int r0 = tile * kTM;
      const int t = r0 + warp;  // this warp's target row
      const float* tp_b = p.tp + b * n * H;
      const float* sp_b = p.sp + b * n * H;
      const float* ea_b = p.ea + b * e * d;
      const int* perm_b = p.perm + b * e;
      const int* src_b = p.src + b * e;
      const int* off_b = p.offsets + b * (n + 1);

      load_tile<H>(p.h + b * n * H, r0, n, s_x0);

      // The stream: this warp's target, its edges in CSR order.
      float acc_e[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc_e[j] = 0.f;
      const int lo = t < n ? off_b[t] : 0;
      const int hi = t < n ? off_b[t + 1] : 0;
      for (int i = lo; i < hi; ++i) {  // uniform across the warp
        const int eid = perm_b[i];
        float a[kMaxD], z[CPL], mu, rstd, f[CPL];
        load_attr(ea_b + static_cast<long long>(eid) * d, d, a);
        edge_z<CPL>(tp_b + static_cast<long long>(t) * H,
                    sp_b + static_cast<long long>(src_b[i]) * H, a, d, s_we,
                    lane, z, mu, rstd);
        mask_factors<CPL>(dr, eid, static_cast<uint32_t>(b), lane, f);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const float y = (z[j] - mu) * rstd * g[j] + bt[j];
          acc_e[j] += (y / (1.f + expf(-y))) * f[j];
        }
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        s_x1[warp * H + lane + 32 * j] = acc_e[j];
        if (t < n) p.summed[(b * n + t) * H + lane + 32 * j] = acc_e[j];
      }
      __syncthreads();

      // agg = summed Wout^T + deg (x) bout
      float acc[kTM];
      {
        const float bo = c < H ? p.bout[c] : 0.f;
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          const int row = r0 + r;
          const float deg = row < n
              ? static_cast<float>(off_b[row + 1] - off_b[row]) : 0.f;
          acc[r] = deg * bo;
        }
      }
      tile_product<H>(acc, s_x1, p.wout, H, H, s_w);
      if (c < H) {
#pragma unroll
        for (int r = 0; r < kTM; ++r) s_x2[r * H + c] = acc[r];
      }
      __syncthreads();

      // z1 = h W1[:, :H]^T + agg W1[:, H:]^T + b1
      {
        const float b1 = c < H ? p.b1[c] : 0.f;
#pragma unroll
        for (int r = 0; r < kTM; ++r) acc[r] = b1;
      }
      tile_product<H>(acc, s_x0, p.w1, 2 * H, H, s_w);
      tile_product<H>(acc, s_x2, p.w1 + H, 2 * H, H, s_w);
      if (c < H) {
#pragma unroll
        for (int r = 0; r < kTM; ++r) s_x1[r * H + c] = acc[r];
      }
      __syncthreads();

      // a = silu(LayerNorm(z1) * g1 + be1) * node_mask: a warp per row.
      {
        float z[CPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          z[j] = s_x1[warp * H + lane + 32 * j];
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
          if (p.node_mask != nullptr && t < n) {
            a *= p.node_mask[(b * n + t) * H + ch];
          }
          s_x1[warp * H + ch] = a;
        }
      }
      __syncthreads();

      // h_new = a W2^T + b2
      {
        const float b2 = c < p.ho ? p.b2[c] : 0.f;
#pragma unroll
        for (int r = 0; r < kTM; ++r) acc[r] = b2;
      }
      tile_product<H>(acc, s_x1, p.w2, H, p.ho, s_w);
      if (c < p.ho) {
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          if (r0 + r < n) {
            p.h_new[(b * n + r0 + r) * p.ho + c] = acc[r];
          }
        }
      }
      // tile_product ends on a barrier: the tiles are free for the next item.
    }
  }
}

template <int CPL>
size_t smem_bytes() {
  return sizeof(float) * (3 * kTM * CPL * 32 + kBK * kLdw + kMaxD * CPL * 32);
}

constexpr int kMaxDevices = 64;

template <int CPL>
cudaError_t launch(const LayerArgs& p, int cooperative, cudaStream_t stream,
                   int* launches) {
  auto kernel = fused_full_fwd_kernel<CPL>;
  const size_t smem = smem_bytes<CPL>();
  // Per device, found at the first launch there: the persistent grid's
  // capacity (resident blocks per SM x SMs), or -1 where the device has no
  // cooperative launch. Racing first launches write the same values.
  static int capacity[kMaxDevices] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (capacity[device] == 0) {
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
    capacity[device] = can ? per_sm * sms : -1;
  }
  const int tiles = (p.n + kTM - 1) / kTM;
  const int items_a = p.b * tiles * 2, items_b = p.b * tiles;
  if (cooperative && capacity[device] > 0) {
    const int grid = items_a < capacity[device] ? items_a : capacity[device];
    LayerArgs args = p;
    int phase = 0;
    void* params[] = {&args, &phase};
    *launches = 1;
    return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                       dim3(grid), dim3(kThreads), params,
                                       smem, stream);
  }
  *launches = 2;
  kernel<<<items_a, kThreads, smem, stream>>>(p, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kernel<<<items_b, kThreads, smem, stream>>>(p, 2);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. Shapes as in LayerArgs above; all
// tensors contiguous float32 (indices int32) on the current device; `w1` is
// the whole (h, 2h) matrix. `node_mask` and `seed` may be null. `tp` and
// `sp` are (b, n, h) scratch. With `cooperative` != 0 and a device that
// supports it the layer is one cooperative launch, else two ordinary
// launches; `*launches` receives which. Launches on `stream` and returns the
// CUDA error code (0 on success).
extern "C" int nbody_fused_full_fwd(
    const float* h, const float* ea, const int* perm, const int* src,
    const int* offsets, const float* wt, const float* bt, const float* ws,
    const float* we, const float* ge, const float* be, const float* wout,
    const float* bout, const float* w1, const float* b1, const float* g1,
    const float* be1, const float* w2, const float* b2,
    const float* node_mask, const int* seed, unsigned int thr, float scale,
    float* tp, float* sp, float* h_new, float* summed, int b, int n, int e,
    int d, int hdim, int ho, int cooperative, int* launches, void* stream) {
  *launches = 0;
  if (b < 0 || n < 0 || e < 0 || d < 0 || d > kMaxD || hdim <= 0 ||
      hdim % 32 != 0 || hdim > kMaxH || ho <= 0 || ho > kThreads ||
      static_cast<long long>(b) * ((n + kTM - 1) / kTM) * 2 > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return 0;
  const LayerArgs p{h, ea, perm, src, offsets, wt, bt, ws, we, ge, be, wout,
                    bout, w1, b1, g1, be1, w2, b2, node_mask, seed, thr,
                    scale, tp, sp, h_new, summed, b, n, e, d, ho};
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
