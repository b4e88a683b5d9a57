// Kernel 7, the whole interaction layer, in its bf16 form (the TPU kernel's
// cd = bfloat16): the C entry point over fused_edge_full.cuh (which holds
// the kernel, its launcher and its notes). Its arguments are
// fused_edge_full.cu's, but for wt and ws in bf16 and `scratch` (bf16)
// where that one takes agg.

#include "fused_edge_full.cuh"

extern "C" int nbody_fused_full_fwd_bf16(
    const float* h, const float* ea, const int* perm, const int* src,
    const int* offsets, const __nv_bfloat16* wt, const float* bt,
    const __nv_bfloat16* ws, const float* we, const float* ge,
    const float* be, const float* wout, const float* bout, const float* w1,
    const float* b1, const float* g1, const float* be1, const float* w2,
    const float* b2, const float* node_mask, const int* seed,
    unsigned int thr, float scale, unsigned int graph0, float* tp, float* sp,
    __nv_bfloat16* scratch, float* z1, float* h_new, float* summed,
    int b, int n, int e, int d, int hdim, int ho, int cooperative,
    int* launches, void* stream) {
  return run<__nv_bfloat16>(h, ea, perm, src, offsets, wt, bt, ws, we, ge,
                            be, wout, bout, w1, b1, g1, be1, w2, b2,
                            node_mask, seed, thr, scale, graph0, tp, sp,
                            scratch, z1, h_new, summed, b, n, e, d, hdim, ho,
                            cooperative, launches, stream);
}
