// Direct O(N^2) softened-gravity accelerations for Hopper (sm_90a): three
// kernels for the three regimes of the simulator, and a fourth that no
// dispatch calls.
//
//   a_i = sum_j G m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}
//
// They replace the Pallas TPU kernels of nbody_gnn_hpc_tpu/ops/pairwise.py:
//   kernel 3  _pairwise_kernel      (pallas_accelerations): i-tiles on the
//             grid, j-tiles in a loop;
//   kernel 4  _pairwise_small_kernel (pallas_accelerations_small): a whole
//             small system at once, an ensemble of systems on the grid;
//   kernel 6  _pairwise_sym_kernel  (pallas_accelerations_symmetric): every
//             tile pair (I, J >= I) computed once, the reaction on the j side
//             by Newton's third law.
//   kernel 5  _pairwise_sym_mxu_kernel (pallas_accelerations_symmetric_mxu):
//             kernel 6's schedule with the mass weighting and the sums done
//             as tensor-core products (its note is below kernel 6's code).
// The TPU layout is not carried over: no (8, N_pad) packing, no transposed
// copy, no padding of N. Positions are read as (N, 3) rows, G*m is formed
// while a tile is staged, a ragged last tile is filled with zero-mass
// sources at the origin (they exert exactly zero force) and rows beyond N
// are never written.
//
// A coincident pair (d^2 == 0, the self pair included) contributes exactly
// zero in all four kernels: the factor is selected away, not multiplied by a
// zero displacement, so G*m/eps^3 overflowing float32 at very large masses
// cannot turn into inf * 0 = NaN. The TPU kernels 4 and 6 rely on s * 0 = 0
// with s finite; the results are equal wherever those are finite.
//
// No float atomics anywhere: every sum is taken in a fixed order, so reruns
// are bit-identical.
//
// Kernel 3 (tiled). One thread per receiver i, 128 receivers per block, the
// batch on grid.y. Sources are staged through shared memory as float4
// (x, y, z, G*m), 128 at a time; a thread keeps its three sums in registers
// and adds sources in ascending j.
//
// Kernel 4 (small). N <= 1024. Each block stages its whole system once
// (N float4, 3.2 KB at N = 200) and computes 128 receivers; grid =
// (ceil(N / 128), B), so a 300-system ensemble is one launch.
//
// Kernel 6 (symmetric). The TPU kernel walks I in grid order and carries the
// j-side reactions in a scratch that step I reads from steps < I; a CUDA grid
// has no order. Here one block of 4 warps owns one tile pair (I, J >= I) of
// 128 x 128 particles and writes into partial[slot, particle, 3], one slot
// per tile:
//   - its i-side row sums go to partial[J, rows of I];
//   - its j-side column sums, weighted by G*m_i and negated, go to
//     partial[I, rows of J];
//   - the diagonal block computes the full plane and writes
//     partial[I, rows of I].
// Every (slot, tile) cell is written by exactly one block; a second launch
// adds the slots of each particle in slot order. Column sums inside a block:
// a lane owns row i and walks the 32 columns of a sub-tile in rotated order
// (column (lane + s) % 32 at step s); the three column accumulators travel
// from lane to lane by warp shuffle, so each column's sum visits the lanes
// in a fixed order and stays in registers. The four warps' column sums are
// added in warp order through shared memory.
//
// Bounds on an H100 (67 TFLOP/s float32 outside the tensor cores; 16
// special-function results per clock per SM against 128 FMA lanes, i.e.
// 67e12 / 16 rsqrt/s; 3.35 TB/s). Per ordered pair kernels 3 and 4 do 19
// float32 operations (3 subtractions; d^2 5; + eps^2 1; cube 2; * G m 1;
// compare-select 1; three FMAs 6) and one rsqrt; per unordered pair kernel 6
// does 27 (3; 5; 1; 2; select 1; s * d 3; i-side FMAs 6; j-side FMAs 6) and
// one rsqrt. Operands are 16 N bytes in, 12 N out. At N = 10,000 kernel 3 has
// 1e8 pairs: 28 us of float32 work, 24 us of rsqrt, 0.08 us of memory;
// kernel 6 has 5e7: 20 us, 12 us. All three are bound by operations; the
// designs keep every pair term in registers. Register tiling (several
// receivers per thread), splitting j over threads at small grids and
// persistent blocks are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kG = 6.67430e-11f;
constexpr int kTile = 128;      // receivers per block; sources per staged tile
constexpr int kMaxSmallN = 1024;
constexpr int kSymWarps = kTile / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// One source as staged in shared memory: (x, y, z, G*m); beyond n a
// zero-mass source at the origin.
__device__ __forceinline__ float4 load_source(const float* __restrict__ pos,
                                              const float* __restrict__ mass,
                                              int j, int n) {
  if (j >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], kG * mass[j]);
}

// s * (dx, dy, dz) with s = (d^2 + eps^2)^(-3/2), zero for a coincident pair.
__device__ __forceinline__ void pair_term(float dx, float dy, float dz,
                                          float soft2, float& tx, float& ty,
                                          float& tz) {
  const float d2 = dx * dx + dy * dy + dz * dz;
  const float inv_r = rsqrtf(d2 + soft2);
  const float s = d2 > 0.f ? inv_r * inv_r * inv_r : 0.f;
  tx = s * dx;
  ty = s * dy;
  tz = s * dz;
}

// Adds source p's pull on a receiver at (xi, yi, zi): f = G m_j / r^3,
// selected to zero for a coincident pair, times the displacement.
__device__ __forceinline__ void add_source(const float4 p, float xi, float yi,
                                           float zi, float soft2, float& ax,
                                           float& ay, float& az) {
  const float dx = p.x - xi, dy = p.y - yi, dz = p.z - zi;
  const float d2 = dx * dx + dy * dy + dz * dz;
  const float inv_r = rsqrtf(d2 + soft2);
  const float f = d2 > 0.f ? p.w * (inv_r * inv_r * inv_r) : 0.f;
  ax += f * dx;
  ay += f * dy;
  az += f * dz;
}

// Kernel 3. grid (ceil(n / kTile), b), block kTile.
__global__ void __launch_bounds__(kTile)
pairwise_tiled_kernel(const float* __restrict__ pos,
                      const float* __restrict__ mass, float* __restrict__ acc,
                      int n, float soft2) {
  __shared__ float4 src[kTile];
  const size_t sys = blockIdx.y;
  pos += sys * n * 3;
  mass += sys * n;
  acc += sys * n * 3;
  const int i = blockIdx.x * kTile + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < n) {
    xi = pos[3 * i];
    yi = pos[3 * i + 1];
    zi = pos[3 * i + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int j0 = 0; j0 < n; j0 += kTile) {
    src[threadIdx.x] = load_source(pos, mass, j0 + threadIdx.x, n);
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kTile; ++t) {
      add_source(src[t], xi, yi, zi, soft2, ax, ay, az);
    }
    __syncthreads();
  }
  if (i < n) {
    acc[3 * i] = ax;
    acc[3 * i + 1] = ay;
    acc[3 * i + 2] = az;
  }
}

// Kernel 4. grid (ceil(n / kTile), b), block kTile, n * sizeof(float4)
// bytes of dynamic shared memory.
__global__ void __launch_bounds__(kTile)
pairwise_small_kernel(const float* __restrict__ pos,
                      const float* __restrict__ mass, float* __restrict__ acc,
                      int n, float soft2) {
  extern __shared__ float4 sys_src[];
  const size_t sys = blockIdx.y;
  pos += sys * n * 3;
  mass += sys * n;
  acc += sys * n * 3;
  for (int j = threadIdx.x; j < n; j += kTile) {
    sys_src[j] = load_source(pos, mass, j, n);
  }
  __syncthreads();
  const int i = blockIdx.x * kTile + threadIdx.x;
  if (i >= n) return;
  const float4 self = sys_src[i];
  float ax = 0.f, ay = 0.f, az = 0.f;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    add_source(sys_src[j], self.x, self.y, self.z, soft2, ax, ay, az);
  }
  acc[3 * i] = ax;
  acc[3 * i + 1] = ay;
  acc[3 * i + 2] = az;
}

// Kernel 6, first launch. grid (tiles, tiles), block kTile; block
// (x = J, y = I) works when J >= I. partial is (tiles, n, 3).
__global__ void __launch_bounds__(kTile)
pairwise_sym_kernel(const float* __restrict__ pos,
                    const float* __restrict__ mass,
                    float* __restrict__ partial, int n, float soft2) {
  const int tile_i = blockIdx.y, tile_j = blockIdx.x;
  if (tile_j < tile_i) return;  // the whole block: the pair is (J, I)'s
  __shared__ float4 src[kTile];
  __shared__ float col[kSymWarps][kTile][3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tile_i * kTile + tid;
  const int j = tile_j * kTile + tid;
  src[tid] = load_source(pos, mass, j, n);
  // A row beyond n takes part in the shuffles with zero mass: its column
  // contributions are exactly zero and its row sums are not written.
  const float4 self = load_source(pos, mass, i, n);
  __syncthreads();
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (tile_i == tile_j) {
#pragma unroll 8
    for (int t = 0; t < kTile; ++t) {
      const float4 p = src[t];
      float tx, ty, tz;
      pair_term(p.x - self.x, p.y - self.y, p.z - self.z, soft2, tx, ty, tz);
      ax += p.w * tx;
      ay += p.w * ty;
      az += p.w * tz;
    }
  } else {
    const int next = (lane + 1) & 31;
    for (int c = 0; c < kTile; c += 32) {
      // At step s this lane holds the sums of column c + (lane + s) % 32.
      float cx = 0.f, cy = 0.f, cz = 0.f;
#pragma unroll 8
      for (int s = 0; s < 32; ++s) {
        const float4 p = src[c + ((lane + s) & 31)];
        float tx, ty, tz;
        pair_term(p.x - self.x, p.y - self.y, p.z - self.z, soft2, tx, ty, tz);
        ax += p.w * tx;
        ay += p.w * ty;
        az += p.w * tz;
        cx += self.w * tx;
        cy += self.w * ty;
        cz += self.w * tz;
        cx = __shfl_sync(kFullMask, cx, next);
        cy = __shfl_sync(kFullMask, cy, next);
        cz = __shfl_sync(kFullMask, cz, next);
      }
      // After 32 steps the sums of column c + lane are back in this lane.
      col[warp][c + lane][0] = cx;
      col[warp][c + lane][1] = cy;
      col[warp][c + lane][2] = cz;
    }
  }
  if (i < n) {
    float* out = partial + (static_cast<size_t>(tile_j) * n + i) * 3;
    out[0] = ax;
    out[1] = ay;
    out[2] = az;
  }
  if (tile_i == tile_j) return;  // the whole block
  __syncthreads();
  if (j < n) {
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int w = 0; w < kSymWarps; ++w) {
      sx += col[w][tid][0];
      sy += col[w][tid][1];
      sz += col[w][tid][2];
    }
    float* out = partial + (static_cast<size_t>(tile_i) * n + j) * 3;
    out[0] = -sx;
    out[1] = -sy;
    out[2] = -sz;
  }
}

// Kernel 6, second launch: acc[c] = sum over slots of partial[slot, c], in
// slot order; cols = 3 n.
__global__ void sum_slots_kernel(const float* __restrict__ partial,
                                 float* __restrict__ acc, int slots,
                                 int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int k = 0; k < slots; ++k) s += partial[static_cast<size_t>(k) * cols + c];
  acc[c] = s;
}

// Kernel 5 (symmetric, tensor-core moments). The TPU kernel moved the mass
// weighting and the six reductions of kernel 6 onto the matrix unit through
// the moment decomposition: with positions centred by the wrapper and
// W_j = G m_j [1, x_j, y_j, z_j, 0, 0, 0, 0],
//   a_i = sum_j s_ij W_j[1:4] - x_i sum_j s_ij W_j[0],  s = (d^2 + eps^2)^-3/2,
// so a tile pair's i side is M = s @ W_J and its j side (Newton's third law)
// Mj = W_I^T @ s, a_j = Mj[1:4] - x_j Mj[0]. On the TPU it was a measured
// negative result, dispatched by nothing: the two terms of the difference
// are |x| / |d| times the force, so rounding is amplified for close pairs.
// The port keeps that status: a public function that no entry point calls.
//
// Schedule: kernel 6's. One block per tile pair (I, J >= I) of 128 x 128
// writes partial[J, rows of I] (i side) and partial[I, rows of J] (j side;
// the diagonal block only the former, over its whole plane), one writer per
// (slot, tile) cell, and sum_slots_kernel adds the slots in order: no float
// atomics, reruns are bit-identical.
//
// A block of 8 warps stages both tiles and their W rows, builds the s-plane
// in shared memory (128 rows of 132 floats, 66 KB of dynamic shared memory;
// zero where d^2 == 0, so a coincident pair and the self pair drop out), and
// then warp w computes rows 16w..16w+15 of M and of Mj^T = s^T @ W_I with
// mma.sync m16n8k8 TF32 tensor-core operations over k = 128 in 16 steps:
// W's width of 8 is exactly the instruction's n. The row pitch of 132 puts
// the i-side fragment loads on 32 distinct banks; the j side reads the plane
// transposed, with 2-way conflicts.
//
// Precision: 3xTF32. A TF32 operand keeps 10 bits of mantissa, about three
// decimal digits, and the moment form multiplies that error by |x| / |d|:
// one TF32 pass misses the float32 tolerance of the JAX package's test by
// orders of magnitude. Each operand is split into hi = tf32(v) and
// lo = tf32(v - hi), and each k step issues lo_a hi_b, hi_a lo_b and
// hi_a hi_b, which keeps about 21 bits of every product (only lo_a lo_b,
// ~2^-22 of it, is dropped). The running sums stay out of the tensor core: its float32
// accumulation does not round as float32 adds do, and carrying the sums
// through every instruction of a row (3 x 16 a tile pair) left one particle
// of an N = 2,085 system 1.6 times the tolerance from the plain version on
// the card. Each k step's three products go into a zeroed fragment, which
// float32 adds then fold into the sums; the kernel is then nearer a float64
// evaluation than the float32 plain version is.
//
// Bounds on an H100. The function's work is kernel 6's (25 float32
// operations and one rsqrt per unordered pair): at N = 10,000, 19 us. This
// design builds each pair's s in 11 float32 operations and one rsqrt (12 us
// of rsqrt), and issues 3 x 2 x 16 x 8 = 768 m16n8k8 operations per tile pair
// (96 TF32 operations a pair, 10 us at the dense 495 TFLOP/s). What bounds it
// is shared memory: 64 KB of s stored and read twice, and 64 KB of W read,
// per tile pair, ~2,000 cycles of the 128 bytes a clock an SM moves, so about
// 26 us at N = 10,000. Fewer passes over the plane (fragments built in
// registers, one product per warp pair) are later work.
constexpr int kMmaThreads = 256;     // 8 warps, 16 rows of each product apiece
constexpr int kSPitch = kTile + 4;   // the s-plane's row pitch in floats
constexpr int kWCols = 8;            // G m [1, x, y, z] padded to the mma's n
constexpr size_t kMmaSmem =
    2 * kTile * sizeof(float4) +
    (static_cast<size_t>(kTile) * kSPitch + 4 * kTile * kWCols) * sizeof(float);

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// c += a @ b for one m16n8k8 tile: a 16 x 8 (row), b 8 x 8 (col), TF32 in,
// float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: out (16 x 8) = A (16 x 128) @ w (128 x 8) in 3xTF32, both in
// shared memory, A[r][k] = a[r * kRow + k * kCol] (the s-plane's rows for
// the i side, its columns for the j side). Fragment layout of m16n8k8 TF32:
// lane = 4 g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4),
// B (t, g), (t + 4, g) and C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <int kRow, int kCol>
__device__ __forceinline__ void warp_moments(const float* a, const float* w,
                                             float* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int k0 = 0; k0 < kTile; k0 += 8) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    split_tf32(a[g * kRow + (k0 + t) * kCol], ah[0], al[0]);
    split_tf32(a[(g + 8) * kRow + (k0 + t) * kCol], ah[1], al[1]);
    split_tf32(a[g * kRow + (k0 + t + 4) * kCol], ah[2], al[2]);
    split_tf32(a[(g + 8) * kRow + (k0 + t + 4) * kCol], ah[3], al[3]);
    split_tf32(w[(k0 + t) * kWCols + g], bh[0], bl[0]);
    split_tf32(w[(k0 + t + 4) * kWCols + g], bh[1], bl[1]);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(d, al, bh);  // the small terms first
    mma_tf32(d, ah, bl);
    mma_tf32(d, ah, bh);
#pragma unroll
    for (int q = 0; q < 4; ++q) c[q] += d[q];
  }
  out[g * kWCols + 2 * t] = c[0];
  out[g * kWCols + 2 * t + 1] = c[1];
  out[(g + 8) * kWCols + 2 * t] = c[2];
  out[(g + 8) * kWCols + 2 * t + 1] = c[3];
}

// Kernel 5, first launch. grid (tiles, tiles), block kMmaThreads, kMmaSmem
// bytes of dynamic shared memory; block (x = J, y = I) works when J >= I.
// pos is centred; partial is (tiles, n, 3).
__global__ void __launch_bounds__(kMmaThreads)
pairwise_sym_mma_kernel(const float* __restrict__ pos,
                        const float* __restrict__ mass,
                        float* __restrict__ partial, int n, float soft2) {
  const int tile_i = blockIdx.y, tile_j = blockIdx.x;
  if (tile_j < tile_i) return;  // the whole block: the pair is (J, I)'s
  extern __shared__ float4 mma_smem[];
  float4* src_i = mma_smem;  // (x, y, z, G m) of I's and J's particles
  float4* src_j = src_i + kTile;
  float* s = reinterpret_cast<float*>(src_j + kTile);  // [kTile][kSPitch]
  float* w_i = s + kTile * kSPitch;                    // [kTile][kWCols]
  float* w_j = w_i + kTile * kWCols;
  float* m_i = w_j + kTile * kWCols;  // M, the i side's moments
  float* m_j = m_i + kTile * kWCols;  // Mj^T, the j side's
  const int tid = threadIdx.x, warp = tid >> 5, r = tid & (kTile - 1);
  const bool diag = tile_i == tile_j, j_half = tid >= kTile;
  {
    // Threads 0..127 stage I's particles, 128..255 J's. A row beyond n is a
    // zero-mass particle at the origin: its W row is zero, so its s values
    // (finite: at most eps^-3) add nothing, and its result is not written.
    const float4 q =
        load_source(pos, mass, (j_half ? tile_j : tile_i) * kTile + r, n);
    (j_half ? src_j : src_i)[r] = q;
    float* w = (j_half ? w_j : w_i) + r * kWCols;
    w[0] = q.w;
    w[1] = q.w * q.x;
    w[2] = q.w * q.y;
    w[3] = q.w * q.z;
    w[4] = w[5] = w[6] = w[7] = 0.f;
  }
  __syncthreads();
  {
    // The s-plane: this thread owns column r (a J particle) and every
    // second row; a warp writes 32 consecutive floats of one row.
    const float4 pj = src_j[r];
    for (int row = tid / kTile; row < kTile; row += kMmaThreads / kTile) {
      const float4 pi = src_i[row];
      const float dx = pj.x - pi.x, dy = pj.y - pi.y, dz = pj.z - pi.z;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float inv_r = rsqrtf(d2 + soft2);
      s[row * kSPitch + r] = d2 > 0.f ? inv_r * inv_r * inv_r : 0.f;
    }
  }
  __syncthreads();
  warp_moments<kSPitch, 1>(s + warp * 16 * kSPitch, w_j,
                           m_i + warp * 16 * kWCols);
  if (!diag) {
    warp_moments<1, kSPitch>(s + warp * 16, w_i, m_j + warp * 16 * kWCols);
  }
  __syncthreads();
  // a = M[1:4] - x M[0]: threads 0..127 for I's rows, 128..255 for J's.
  if (j_half && diag) return;
  const int p = (j_half ? tile_j : tile_i) * kTile + r;
  if (p >= n) return;
  const float* m = (j_half ? m_j : m_i) + r * kWCols;
  const float4 q = (j_half ? src_j : src_i)[r];
  float* out =
      partial + (static_cast<size_t>(j_half ? tile_i : tile_j) * n + p) * 3;
  out[0] = m[1] - q.x * m[0];
  out[1] = m[2] - q.y * m[0];
  out[2] = m[3] - q.z * m[0];
}

}  // namespace

// Plain C entry points, called through ctypes. pos (b, n, 3), mass (b, n),
// acc (b, n, 3) float32, contiguous, on one device; soft2 = eps^2. The
// symmetric forms (kernels 6 and 5) take one system (n, 3) and a
// (ceil(n / 128), n, 3) float32 scratch. They launch on `stream` and return cudaGetLastError() (0 on
// success).

extern "C" int nbody_pairwise_tiled(const float* pos, const float* mass,
                                    float* acc, int b, int n, float soft2,
                                    void* stream) {
  if (b < 0 || n < 0 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || n == 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, b);
  pairwise_tiled_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, mass, acc, n, soft2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nbody_pairwise_small(const float* pos, const float* mass,
                                    float* acc, int b, int n, float soft2,
                                    void* stream) {
  if (b < 0 || n < 0 || b > 65535 || n > kMaxSmallN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, b);
  pairwise_small_kernel<<<grid, kTile, n * sizeof(float4),
                          static_cast<cudaStream_t>(stream)>>>(pos, mass, acc,
                                                               n, soft2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nbody_pairwise_symmetric(const float* pos, const float* mass,
                                        float* partial, float* acc, int n,
                                        float soft2, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pairwise_sym_kernel<<<dim3(tiles, tiles), kTile, 0, s>>>(pos, mass, partial,
                                                           n, soft2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = 3 * n;
  sum_slots_kernel<<<(cols + 255) / 256, 256, 0, s>>>(partial, acc, tiles,
                                                      cols);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 5: pos is one centred system (n, 3), partial a (ceil(n / 128), n, 3)
// float32 scratch, as for the symmetric form.
extern "C" int nbody_pairwise_symmetric_mma(const float* pos, const float* mass,
                                            float* partial, float* acc, int n,
                                            float soft2, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_sym_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pairwise_sym_mma_kernel<<<dim3(tiles, tiles), kMmaThreads, kMmaSmem, s>>>(
      pos, mass, partial, n, soft2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = 3 * n;
  sum_slots_kernel<<<(cols + 255) / 256, 256, 0, s>>>(partial, acc, tiles,
                                                      cols);
  return static_cast<int>(cudaGetLastError());
}
