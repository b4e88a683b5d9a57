// Kernels 1 and 2, the fused edge stream, in the bf16 stream: the C entry
// points over fused_edge.cuh (which holds the kernels and their notes).
// Their arguments are fused_edge.cu's, with tp, sp, d_tp and d_sp bfloat16
// (out, gout, ea, we, gamma, beta, d_ea and d_params float32).

#include "fused_edge.cuh"

extern "C" int nbody_fused_edge_fwd_bf16(
    const void* tp, const void* sp, const float* ea, const float* we,
    const float* gamma, const float* beta, const int* perm, const int* src,
    const int* offsets, const long long* col, long long col_stride,
    const int* seed, unsigned int thr, float scale, unsigned int graph0,
    float* out, float* part,
    int* arrivals, int b, int n, int e, int d, int h, int chunk, int warps,
    void* stream) {
  using T = __nv_bfloat16;
  return launch_fwd(static_cast<const T*>(tp), static_cast<const T*>(sp), ea,
                    we, gamma, beta, perm, src, offsets, col, col_stride,
                    seed, thr, scale, graph0, out, part, arrivals, b, n, e, d,
                    h, chunk, warps, stream);
}

extern "C" int nbody_fused_edge_bwd_bf16(
    const void* tp, const void* sp, const float* ea, const float* we,
    const float* gamma, const float* beta, const int* perm, const int* src,
    const int* offsets, const long long* col, long long col_stride,
    const int* sperm, const int* sdst, const int* soffsets,
    const long long* row, long long row_stride, const float* gout,
    const int* seed, unsigned int thr, float scale, unsigned int graph0,
    void* d_tp, void* d_sp,
    float* d_ea, float* part, int* arrivals, unsigned int* rec,
    float* part_par, float* d_params, int b, int n, int e, int d, int h,
    int chunk, int warps, void* stream) {
  using T = __nv_bfloat16;
  return launch_bwd(static_cast<const T*>(tp), static_cast<const T*>(sp), ea,
                    we, gamma, beta, perm, src, offsets, col, col_stride,
                    sperm, sdst, soffsets, row, row_stride, gout, seed, thr,
                    scale, graph0, static_cast<T*>(d_tp), static_cast<T*>(d_sp),
                    d_ea, part, arrivals, rec, part_par, d_params, b, n, e, d,
                    h, chunk, warps, stream);
}
