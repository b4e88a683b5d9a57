// Kernels 1 and 2, the fused edge stream, in the float32 stream: the C entry
// points over fused_edge.cuh (which holds the kernels and their notes).

#include "fused_edge.cuh"

// C entry points, loaded with ctypes. Shapes: tp, sp, gout, out, d_tp, d_sp
// (b, n, h); ea, d_ea (b, e, d); we (d, h); gamma, beta (h,); perm, src (b, e)
// int32, the target-major CSR; sperm, sdst (b, e) int32, the source-major
// CSR; offsets, soffsets (b, n + 1) int32; col, row (b, e) int64 with row
// stride col_stride, row_stride, 0 where the graphs share their edges (the
// target and source of each edge id); seed (1,) int32 or null (no dropout);
// graph0 the index of graph 0 in the whole batch, for the dropout counter (0
// unless the batch is a data-parallel rank's rows of a larger one).
// Both walks: chunk <= 128 CSR positions a block of `warps` warps; part (b,
// blocks, 2, h) scratch with blocks = ceil(e / chunk), or 1 without edges;
// arrivals (b * blocks,) int32, all zero, and zero again when the launch
// ends. Backward: rec (b, e, 4 + h / 32) int32 and part_par (b * blocks, d +
// 2, h) scratch; d_params (d + 2, h) = [d_we; d_gamma; d_beta]; d_ea null
// where not wanted. All else contiguous, on one device. They launch on
// `stream` and return the first CUDA error (0 on success).

extern "C" int nbody_fused_edge_fwd(
    const float* tp, const float* sp, const float* ea, const float* we,
    const float* gamma, const float* beta, const int* perm, const int* src,
    const int* offsets, const long long* col, long long col_stride,
    const int* seed, unsigned int thr, float scale, unsigned int graph0,
    float* out, float* part,
    int* arrivals, int b, int n, int e, int d, int h, int chunk, int warps,
    void* stream) {
  return launch_fwd(tp, sp, ea, we, gamma, beta, perm, src, offsets, col,
                    col_stride, seed, thr, scale, graph0, out, part, arrivals,
                    b, n, e, d, h, chunk, warps, stream);
}

extern "C" int nbody_fused_edge_bwd(
    const float* tp, const float* sp, const float* ea, const float* we,
    const float* gamma, const float* beta, const int* perm, const int* src,
    const int* offsets, const long long* col, long long col_stride,
    const int* sperm, const int* sdst, const int* soffsets,
    const long long* row, long long row_stride, const float* gout,
    const int* seed, unsigned int thr, float scale, unsigned int graph0,
    float* d_tp, float* d_sp,
    float* d_ea, float* part, int* arrivals, unsigned int* rec,
    float* part_par, float* d_params, int b, int n, int e, int d, int h,
    int chunk, int warps, void* stream) {
  return launch_bwd(tp, sp, ea, we, gamma, beta, perm, src, offsets, col,
                    col_stride, sperm, sdst, soffsets, row, row_stride, gout,
                    seed, thr, scale, graph0, d_tp, d_sp, d_ea, part,
                    arrivals, rec, part_par, d_params, b, n, e, d, h, chunk,
                    warps, stream);
}
