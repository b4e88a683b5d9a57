// Rate probes for Hopper (sm_90a): how many float32 FMAs and special-function
// rsqrts a second this card sustains, so that the bounds the port's kernels
// are held to can be set beside measured ceilings and not only the data
// sheet's.
//
// They replace the two Pallas TPU kernels of benchmarks/roofline.py:
//   kernel 10  _vpu_fma_kernel   (:184): per element of a float32 tile, four
//              independent accumulators, all starting at x, run k steps of
//              a_n <- a_n * c_n + x with c = 0.9999, 0.9998, 0.9997, 0.9996;
//   kernel 11  _vpu_rsqrt_kernel (:214): four accumulators starting at x,
//              x + 1, x + 2, x + 3 run k steps of a_n <- rsqrt(a_n) + 1e-4;
// both store (a1 + a2) + (a3 + a4). Templated on the number of accumulators
// (1 or 4) and given the multipliers, starting offsets and addend, the same
// two kernels compute the script's one-accumulator dependent chains
// (fma_chain :94, x * 0.9999 + 1e-4; rsqrt_chain :122) and its XLA
// four-accumulator chain (:145), which XLA fused into one loop kernel each.
// Eager PyTorch has no such fused loop: an op-by-op chain measures memory
// traffic, not issue rate.
//
// What bounds them on an H100: issue, and nothing else. One thread per
// element keeps its accumulators in registers; x is read once and the result
// written once, 8 bytes per element against 2 k NACC float32 operations. The
// FMA is __fmaf_rn, one FFMA of the FP32 pipe (128 lanes per SM, 67 TFLOP/s
// at 132 SMs and 1.98 GHz); the rsqrt is rsqrtf, one MUFU.RSQ of the
// special-function unit (16 per SM per clock, 67e12 / 16 a second) and one
// FADD on the FP32 pipe. Each SM holds up to 64 warps, and with NACC
// independent chains a thread, the 4-cycle FMA latency is hidden: the FMA
// probe should read the FP32 pipe's issue rate and the rsqrt probe the
// special-function unit's. Elision is guarded as in the script: every
// operand depends on the data (x and the accumulators) and every result is
// stored.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAcc = 4;

// a_n <- fma(a_n, mul[n], add) with add = add_x * x + add_c, starting at
// x + start[n].
struct FmaParams {
  float mul[kMaxAcc];
  float start[kMaxAcc];
  float add_x;
  float add_c;
};

// a_n <- rsqrt(a_n) + add, starting at x + start[n].
struct RsqrtParams {
  float start[kMaxAcc];
  float add;
};

template <int kAcc>
__device__ __forceinline__ float combine(const float (&a)[kAcc]) {
  if constexpr (kAcc == 1) {
    return a[0];
  } else {
    return (a[0] + a[1]) + (a[2] + a[3]);
  }
}

template <int kAcc>
__global__ void __launch_bounds__(kThreads)
fma_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long n, int steps, FmaParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  const float add = p.add_x * xi + p.add_c;  // x or the constant, exactly
  float a[kAcc];
#pragma unroll
  for (int q = 0; q < kAcc; ++q) a[q] = xi + p.start[q];
#pragma unroll 8
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int q = 0; q < kAcc; ++q) a[q] = __fmaf_rn(a[q], p.mul[q], add);
  }
  out[i] = combine<kAcc>(a);
}

template <int kAcc>
__global__ void __launch_bounds__(kThreads)
rsqrt_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                   long long n, int steps, RsqrtParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float a[kAcc];
#pragma unroll
  for (int q = 0; q < kAcc; ++q) a[q] = xi + p.start[q];
#pragma unroll 8
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int q = 0; q < kAcc; ++q) a[q] = rsqrtf(a[q]) + p.add;
  }
  out[i] = combine<kAcc>(a);
}

bool bad_shape(long long n, int steps, int n_acc) {
  return n < 0 || steps < 0 || (n_acc != 1 && n_acc != kMaxAcc) ||
         (n + kThreads - 1) / kThreads > 0x7fffffffLL;
}

}  // namespace

// Plain C entry points, called through ctypes. x and out are n contiguous
// float32 on one device; mul and start are host arrays of n_acc floats (1 or
// 4). They launch on `stream` and return cudaGetLastError() (0 on success).

extern "C" int nbody_fma_probe(const float* x, float* out, long long n,
                               int steps, int n_acc, const float* mul,
                               const float* start, float add_x, float add_c,
                               void* stream) {
  if (bad_shape(n, steps, n_acc)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  FmaParams p = {};
  for (int q = 0; q < n_acc; ++q) {
    p.mul[q] = mul[q];
    p.start[q] = start[q];
  }
  p.add_x = add_x;
  p.add_c = add_c;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_acc == 1) {
    fma_probe_kernel<1><<<blocks, kThreads, 0, s>>>(x, out, n, steps, p);
  } else {
    fma_probe_kernel<kMaxAcc><<<blocks, kThreads, 0, s>>>(x, out, n, steps, p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nbody_rsqrt_probe(const float* x, float* out, long long n,
                                 int steps, int n_acc, const float* start,
                                 float add, void* stream) {
  if (bad_shape(n, steps, n_acc)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  RsqrtParams p = {};
  for (int q = 0; q < n_acc; ++q) p.start[q] = start[q];
  p.add = add;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_acc == 1) {
    rsqrt_probe_kernel<1><<<blocks, kThreads, 0, s>>>(x, out, n, steps, p);
  } else {
    rsqrt_probe_kernel<kMaxAcc><<<blocks, kThreads, 0, s>>>(x, out, n, steps, p);
  }
  return static_cast<int>(cudaGetLastError());
}
