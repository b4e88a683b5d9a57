// Device functions shared by the edge-stream kernels (fused_edge.cu) and the
// whole-layer kernel (fused_edge_full.cu): the Philox4x32-10 dropout mask,
// the warp sum, an edge's features and the per-lane layout of W_e.  Both
// files draw the same mask bits for the same (seed, graph, edge, channel), so
// a layer run through either agrees with the other and with the plain
// PyTorch version (ops/fused_edge.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nbody_edge {

constexpr int kWarps = 8;   // warps per block
constexpr int kMaxD = 8;    // widest edge-feature vector (production: 5)
constexpr int kMaxH = 256;  // widest hidden size (H = 32 * channels per lane)
constexpr float kEps = 1e-6f;  // flax.linen.LayerNorm default

struct Dropout {
  bool on;
  uint32_t key;
  uint32_t thr;     // keep iff bits >= thr
  float scale;      // 1 / (1 - p)
  uint32_t graph0;  // index of the launch's graph 0 in the whole batch
};

// Philox4x32-10 (Salmon et al., SC'11): four 32-bit words per counter.
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0,
                                        uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Dropout factor of each of the lane's channels lane + 32*j of edge `eid` in
// the launch's graph `b`: scale where kept, 0 where dropped, 1 without
// dropout. The counter takes the graph's index in the whole batch, b +
// graph0, so a data-parallel rank that holds rows [graph0, graph0 + B) of a
// batch draws the bits a single device draws for those rows (graph0 = 0
// without sharding).
template <int CPL>
__device__ __forceinline__ void mask_factors(const Dropout& dr, uint32_t eid,
                                             uint32_t b, int lane,
                                             float (&f)[CPL]) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) f[j] = 1.f;
  if (!dr.on) return;
#pragma unroll
  for (int j0 = 0; j0 < CPL; j0 += 4) {
    const uint4 r =
        philox(lane + 32 * (j0 / 4), eid, b + dr.graph0, 0u, dr.key, 0u);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j0 + q < CPL) f[j0 + q] = w[q] >= dr.thr ? dr.scale : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane ends with the identical sum.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load_attr(const float* ea_e, int d,
                                          float (&a)[kMaxD]) {
#pragma unroll
  for (int q = 0; q < kMaxD; ++q) a[q] = q < d ? ea_e[q] : 0.f;
}

// W_e laid out per lane for 16-byte reads: lane l's channels l + 32j of
// edge feature k at s_wl[l * kStride + k * CPL4 + j], rows padded so eight
// neighbouring lanes read distinct banks.
template <int CPL>
struct LaneWe {
  static constexpr int CPL4 = (CPL + 3) / 4 * 4;
  static constexpr int kStride = kMaxD * CPL4 + 4;
  static constexpr int kFloats = 32 * kStride;
};

}  // namespace nbody_edge
