// The receiver sum of a graph network with per-edge state (GNS's aggregation
// of the edge block's new edges at their receivers): out[b, t, :] is the sum
// of msg[b, e, :] over the edges e whose receiver is t, taken in the order of
// the target-major CSR (ops/fused_edge.py target_csr: perm[b, offsets[b, t]
// .. offsets[b, t + 1]]), one float32 add after another.
//
// It replaces no TPU kernel: the JAX package has no model with per-edge
// latents, and its sum at targets (ops/edges.py aggregate_to_targets) is
// XLA's segment_sum.  On the card PyTorch's index_add_ / scatter_add_ add
// with float atomics, whose order changes from run to run; the port adds no
// floats with atomics, so a training step is bit-identical when it is
// repeated and when its CUDA graph replays it.  The same kernel is the
// backward of the gather at the receivers (ops/edge_sum.py).
//
// What bounds it on an H100: bytes.  It reads every message row once (B E F
// float32), the CSR (E + N + 1 int32) and writes B N F float32, against one
// add a message element: at GNS's shapes (B=2, E=200,000, F=128) 212 MB for
// 51 MFLOP, 63 us at 3.35 TB/s.  Design: one warp a target, each lane four
// channels as a float4, so a 128-wide message row is read as one whole
// 512-byte line (GNS's latent width; F up to 128).
// The warp loads 32 of the target's edge ids at once, one a lane, and hands
// them round by shuffles; four rows are in flight before their adds, which
// stay in CSR order.  Targets are flattened over the batch, so the grid
// does not depend on the degree distribution.  No shared memory, no
// atomics, no scratch: the launch is graph-capturable.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// Lane l holds channels 4 l .. 4 l + 3 (none where 4 l >= f).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
receiver_sum_kernel(const float* __restrict__ msg, const int* __restrict__ perm,
                    const int* __restrict__ offsets, float* __restrict__ out,
                    int b, int n, int e, int f) {
  const int lane = threadIdx.x & 31;
  const long long target =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (target >= static_cast<long long>(b) * n) return;
  const int g = static_cast<int>(target / n);
  const int t = static_cast<int>(target - static_cast<long long>(g) * n);
  const int* gperm = perm + static_cast<long long>(g) * e;
  const int* goff = offsets + static_cast<long long>(g) * (n + 1);
  const int col = 4 * lane;
  const bool active = col < f;
  const float* gmsg = msg + static_cast<long long>(g) * e * f + col;
  const int beg = __ldg(goff + t);
  const int end = __ldg(goff + t + 1);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 zero = acc;
  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const int mine = lane < cnt ? __ldg(gperm + base + lane) : 0;
    int j = 0;
    for (; j + kUnroll <= cnt; j += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int id = __shfl_sync(0xffffffffu, mine, j + u);
        v[u] = active ? __ldg(reinterpret_cast<const float4*>(
                            gmsg + static_cast<long long>(id) * f))
                      : zero;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add4(acc, v[u]);
    }
    for (; j < cnt; ++j) {
      const int id = __shfl_sync(0xffffffffu, mine, j);
      if (active)
        add4(acc, __ldg(reinterpret_cast<const float4*>(
                      gmsg + static_cast<long long>(id) * f)));
    }
  }
  if (active) *reinterpret_cast<float4*>(out + target * f + col) = acc;
}

}  // namespace

// C entry point, loaded with ctypes.  msg (b, e, f) float32; perm (b, e) and
// offsets (b, n + 1) int32, the target-major CSR of each graph's edges; out
// (b, n, f) float32, every element written.  All contiguous, on one device,
// msg 16-byte aligned; f a multiple of 4 up to 128 (ops/edge_sum.py checks
// them).  Launches on `stream` and returns the launch's CUDA error (0 on
// success).
extern "C" int nbody_receiver_sum(const float* msg, const int* perm,
                                  const int* offsets, float* out, int b,
                                  int n, int e, int f, void* stream) {
  const long long targets = static_cast<long long>(b) * n;
  if (targets == 0 || f == 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(
      static_cast<unsigned>((targets + kWarpsPerBlock - 1) / kWarpsPerBlock));
  receiver_sum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      msg, perm, offsets, out, b, n, e, f);
  return static_cast<int>(cudaGetLastError());
}
