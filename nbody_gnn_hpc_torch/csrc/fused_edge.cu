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
// stably sorted by target, their sources, per-target offsets). One block of 8
// warps owns one (graph, target). Warp w walks edges w, w+8, ... of the
// target; a lane holds H/32 channels (lane + 32*j: coalesced), LayerNorm
// statistics are a butterfly shuffle, the SiLU outputs accumulate in
// registers and the 8 warp sums are added in warp order. No float atomics:
// reruns are bit-identical.
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
// outside the tensor cores; the design keeps every (E, H) intermediate in
// registers and recomputes the stream instead of storing it (pass B pays a
// second recompute to avoid a 196 MB scratch round trip). At N=200 per graph
// both are also latency bound: each warp walks a dependent chain of ~5 edges
// (forward) or ~40 (backward). Tensor cores, TMA and prefetching the next
// edge's indices are later work.

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
                      const int* __restrict__ seed, uint32_t thr, float scale,
                      float* __restrict__ out, int n, int e, int d) {
  constexpr int H = CPL * 32;
  __shared__ float s_we[kMaxD * H];
  __shared__ float s_part[kWarps * H];

  const int node = blockIdx.x;
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Dropout dr{seed != nullptr, seed ? static_cast<uint32_t>(seed[0]) : 0u,
                   thr, scale};

  for (int i = threadIdx.x; i < d * H; i += blockDim.x) s_we[i] = we[i];

  const float* tp_t = tp + (b * n + node) * H;
  const float* sp_b = sp + b * n * H;
  const float* ea_b = ea + b * e * d;
  const int* perm_b = perm + b * e;
  const int* src_b = src + b * e;

  float g[CPL], bt[CPL], acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    g[j] = gamma[c];
    bt[j] = beta[c];
    acc[j] = 0.f;
  }
  __syncthreads();

  const int lo = offsets[b * (n + 1) + node];
  const int hi = offsets[b * (n + 1) + node + 1];
  // The loop bound is uniform across the warp, so every shuffle runs with
  // all 32 lanes present.
  for (int i = lo + warp; i < hi; i += kWarps) {
    const int eid = perm_b[i];
    float a[kMaxD], z[CPL], mu, rstd, f[CPL];
    load_attr(ea_b + static_cast<long long>(eid) * d, d, a);
    edge_z<CPL>(tp_t, sp_b + static_cast<long long>(src_b[i]) * H, a, d, s_we,
                lane, z, mu, rstd);
    mask_factors<CPL>(dr, eid, static_cast<uint32_t>(b), lane, f);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float y = (z[j] - mu) * rstd * g[j] + bt[j];
      acc[j] += (y / (1.f + expf(-y))) * f[j];
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

bool bad_shape(int b, int n, int e, int d, int h) {
  return b < 0 || b > 65535 || n < 0 || e < 0 || d < 0 || d > kMaxD ||
         h <= 0 || h % 32 != 0 || h > kMaxH;
}

}  // namespace

// C entry points, loaded with ctypes. Shapes: tp, sp, gout, out, d_tp, d_sp
// (b, n, h); ea, d_ea (b, e, d); we (d, h); gamma, beta (h,); perm, src,
// sperm, sdst (b, e) int32; offsets, soffsets (b, n + 1) int32; seed (1,)
// int32 or null (no dropout); part (b, ceil(n / 8), d + 2, h) scratch;
// d_params (d + 2, h) = [d_we; d_gamma; d_beta]. All contiguous, on one
// device. They launch on `stream` and return cudaGetLastError() (0 on
// success).

extern "C" int nbody_fused_edge_fwd(const float* tp, const float* sp,
                                    const float* ea, const float* we,
                                    const float* gamma, const float* beta,
                                    const int* perm, const int* src,
                                    const int* offsets, const int* seed,
                                    unsigned int thr, float scale, float* out,
                                    int b, int n, int e, int d, int h,
                                    void* stream) {
  if (bad_shape(b, n, e, d, h)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || n == 0) return 0;
  const dim3 grid(n, b);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NBODY_LAUNCH(CPL)                                                   \
  fused_edge_fwd_kernel<CPL><<<grid, block, 0, s>>>(                        \
      tp, sp, ea, we, gamma, beta, perm, src, offsets, seed, thr, scale, out, \
      n, e, d)
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
