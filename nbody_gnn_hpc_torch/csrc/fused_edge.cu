// Fused edge-stream forward of the GNN interaction layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nbody_gnn_hpc_tpu/ops/fused_edge.py:_fwd_kernel
// (inference form: float32, no dropout). Per graph, with edges (row -> col):
//
//   z_e   = t_proj[col_e] + s_proj[row_e] + edge_attr_e @ W_e          (H,)
//   y_e   = (z_e - mean) * rsqrt(mean(z_e^2) - mean^2 + 1e-6) * gamma + beta
//   a_e   = silu(y_e)
//   out_t = sum over edges e with col_e == t of a_e                     (N, H)
//
// Design. The TPU kernel sums at the targets with one-hot (E, N) matmuls on
// its matrix unit; here the wrapper hands over a target-major CSR instead
// (edge ids stably sorted by target, their sources, and per-target offsets).
// One block of 8 warps owns one (graph, target) pair. Warp w walks that
// target's incoming edges w, w+8, ... in CSR order; each lane holds H/32
// channels (lane + 32*j, so a warp's loads are coalesced), the LayerNorm
// statistics are a warp shuffle reduction, and the SiLU outputs accumulate
// in registers. The 8 per-warp partial sums are then added in warp order
// through shared memory. No float atomics: every sum is taken in a fixed
// order, so reruns are bit-identical. t_proj[target] is loaded once per
// block, since every edge of the block shares it.
//
// Bound on an H100 at the serving shape (N=200, k=40, E=8000, H=256, one
// graph): it must read 2*N*H*4 bytes of projections, E*5*4 bytes of edge
// features and the CSR, and write N*H*4 bytes, about 0.85 MB (0.25 us at
// 3.35 TB/s); it does (13 + 2*5)*E*H = 47 MFLOP of float32 work outside
// the tensor cores (0.70 us at 67 TFLOP/s). Both are far below a kernel
// launch, so at this size the kernel is bound by launch and latency: 200
// blocks of 256 threads on 132 SMs, each warp a short dependent chain of
// about five edges. The design keeps every intermediate in registers (the
// (E, H) stream never reaches device memory) and uses one launch per layer
// for the whole graph batch (grid.y = graph), so a batch of B graphs costs
// the same launch as one. Tensor cores, TMA and wider tiles are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // warps per block, each walking its own edges
constexpr int kMaxD = 8;    // widest edge-feature vector (production: 5)
constexpr int kMaxH = 256;  // widest hidden size (H = 32 * channels per lane)
constexpr float kEps = 1e-6f;  // flax.linen.LayerNorm default

template <int CPL>  // channels per lane; H = 32 * CPL
__global__ void __launch_bounds__(kWarps * 32)
fused_edge_fwd_kernel(const float* __restrict__ tp,
                      const float* __restrict__ sp,
                      const float* __restrict__ ea,
                      const float* __restrict__ we,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const int* __restrict__ perm,
                      const int* __restrict__ src,
                      const int* __restrict__ offsets,
                      float* __restrict__ out,
                      int n, int e, int d) {
  constexpr int H = CPL * 32;
  __shared__ float s_we[kMaxD * H];
  __shared__ float s_part[kWarps * H];

  const int node = blockIdx.x;
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < d * H; i += blockDim.x) s_we[i] = we[i];

  const float* tp_t = tp + (b * n + node) * H;
  const float* sp_b = sp + b * n * H;
  const float* ea_b = ea + b * e * d;
  const int* perm_b = perm + b * e;
  const int* src_b = src + b * e;

  float t[CPL], g[CPL], bt[CPL], acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    t[j] = tp_t[c];
    g[j] = gamma[c];
    bt[j] = beta[c];
    acc[j] = 0.f;
  }
  __syncthreads();

  const int lo = offsets[b * (n + 1) + node];
  const int hi = offsets[b * (n + 1) + node + 1];
  const float inv_h = 1.f / H;
  // The loop bound is uniform across the warp, so every shuffle below runs
  // with all 32 lanes present.
  for (int i = lo + warp; i < hi; i += kWarps) {
    const long long eid = perm_b[i];
    const float* sp_s = sp_b + static_cast<long long>(src_b[i]) * H;
    float a[kMaxD];
#pragma unroll
    for (int q = 0; q < kMaxD; ++q) a[q] = q < d ? ea_b[eid * d + q] : 0.f;

    float z[CPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      float pe = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxD; ++q) {
        if (q < d) pe = fmaf(a[q], s_we[q * H + c], pe);
      }
      const float v = t[j] + sp_s[c] + pe;
      z[j] = v;
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
    // Butterfly all-reduce: each step adds the same two operands on both
    // partner lanes, so every lane ends with the identical sum.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mu = s1 * inv_h;
    const float rstd = rsqrtf(s2 * inv_h - mu * mu + kEps);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float y = (z[j] - mu) * rstd * g[j] + bt[j];
      acc[j] += y / (1.f + expf(-y));
    }
  }

#pragma unroll
  for (int j = 0; j < CPL; ++j) s_part[warp * H + lane + 32 * j] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_part[w * H + c];
    out[(b * n + node) * H + c] = s;
  }
}

}  // namespace

// C entry point, loaded with ctypes. Shapes: tp, sp, out (b, n, h);
// ea (b, e, d); we (d, h); gamma, beta (h,); perm, src (b, e) int32;
// offsets (b, n + 1) int32. All contiguous, on one device. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nbody_fused_edge_fwd(const float* tp, const float* sp,
                                    const float* ea, const float* we,
                                    const float* gamma, const float* beta,
                                    const int* perm, const int* src,
                                    const int* offsets, float* out, int b,
                                    int n, int e, int d, int h,
                                    void* stream) {
  if (b < 0 || b > 65535 || n < 0 || e < 0 || d < 0 || d > kMaxD ||
      h <= 0 || h % 32 != 0 || h > kMaxH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return 0;
  const dim3 grid(n, b);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NBODY_LAUNCH(CPL)                                                   \
  fused_edge_fwd_kernel<CPL><<<grid, block, 0, s>>>(                        \
      tp, sp, ea, we, gamma, beta, perm, src, offsets, out, n, e, d)
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
