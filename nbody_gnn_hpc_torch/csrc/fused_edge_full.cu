// Kernel 7, the whole interaction layer, in float32: the C entry point over
// fused_edge_full.cuh (which holds the kernel, its launcher and its notes).

#include "fused_edge_full.cuh"

// Loaded with ctypes; the arguments are those of run() in the header.
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
  return run<float>(h, ea, perm, src, offsets, wt, bt, ws, we, ge, be, wout,
                    bout, w1, b1, g1, be1, w2, b2, node_mask, seed, thr,
                    scale, graph0, tp, sp, agg, z1, h_new, summed, b, n, e,
                    d, hdim, ho, cooperative, launches, stream);
}
