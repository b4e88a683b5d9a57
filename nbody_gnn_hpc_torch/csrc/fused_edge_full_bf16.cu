// Kernel 7, the whole interaction layer, in its bf16 form (the TPU kernel's
// cd = bfloat16): the C entry point over fused_edge_full.cuh (which holds
// the kernel, its launcher and its notes). Its arguments are
// fused_edge_full.cu's, all float32 (wt and ws hold bf16 values widened;
// the kernel rounds every product operand to bf16 itself).

#include "fused_edge_full.cuh"

extern "C" int nbody_fused_full_fwd_bf16(
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
  return run<__nv_bfloat16>(h, ea, perm, src, offsets, wt, bt, ws, we, ge,
                            be, wout, bout, w1, b1, g1, be1, w2, b2,
                            node_mask, seed, thr, scale, graph0, tp, sp, agg,
                            z1, h_new, summed, b, n, e, d, hdim, ho,
                            cooperative, launches, stream);
}
