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
//             the tile-pair schedule with the mass weighting and the sums
//             done as tensor-core products (its note is below its code).
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
// No float atomics anywhere: every sum is taken in a fixed order, and every
// launch shape is a function of the shape and the device alone, so reruns
// are bit-identical.
//
// Kernel 3 (tiled). One thread per receiver i, 128 receivers per block, the
// batch on grid.y. Sources are staged through shared memory as float4
// (x, y, z, G*m), 128 at a time; a thread keeps its three sums in registers
// and adds sources in ascending j.
//
// What bounds kernels 4 and 6 on an H100. The card's float32 rate (67
// TFLOP/s, an FMA counted as two) and its rsqrt rate (16 a clock an SM, 1/8
// of the FMA lanes) give the bounds the benchmark divides by: per ordered
// pair (kernels 3, 4) 18 float32 operations and one rsqrt, per unordered
// pair (kernel 6) 25 and one; operands are 16 N bytes in, 12 N out, so
// every form is bound by operations. Neither bound is reachable: about half
// of a pair's instructions are not FMAs (subtractions, the rsqrt, the
// compare-select of the coincident-pair mask), and a scheduler issues one
// warp instruction a clock whatever its kind. The instruction-issue floor is
// what the designs aim at: 16 issue slots an ordered pair (3 FADD; FMUL +
// 2 FFMA for d^2; FADD eps^2; MUFU.RSQ; 2 FMUL for r^-3; FMUL by G m_j;
// FSETP + FSEL; 3 FFMA), 20 an unordered pair (the same to the select, 2
// FMUL for G m_j r^-3 and G m_i r^-3, 6 FFMA), plus the staged source's
// shared-memory load and, in kernel 6, three shuffles, each shared by
// several receivers. At 4 x 132 warp instructions a clock (the card holds
// 1.98 GHz under these kernels) that is ~6 us for 300 systems of N = 200
// (12e6 pairs; bound 3.2 us) and ~32 us for N = 10,000 (5e7 unordered
// pairs, ~21.5 slots each with the loads and shuffles; bound 18.7 us);
// FMA-only code sustains 86 % of the issue rate on this card. The rsqrt
// is rsqrt.approx.ftz: rsqrtf without flush-to-zero adds a denormal fix-up
// of three instructions a pair. Its argument d^2 + eps^2 is normal for any
// softening above 1e-19; below that, a denormal argument flushes to an inf
// result where rsqrtf gives one above 9e18, and the cube of either
// overflows float32 alike.
//
// Kernel 4 (small, the ensemble force of datagen). N <= 1024. The work is
// flattened over the ensemble: a receiver group is r consecutive receivers
// of one system (register tiling: one staged source serves r pairs), and k
// lanes share a group, lane p taking sources p, p + k, ... in ascending
// order; the k partial sums are added by xor shuffles in a fixed order.
// Groups are numbered system-major and dealt to blocks in order, so no lane
// idles on a ragged system, and a block stages every system it touches
// once (16-byte loads of the position rows where aligned). The block is
// sized so that one block an SM holds the whole ensemble where it fits
// (up to 1,024 threads), which evens the SMs' loads to a warp: blocks of a
// fixed 128 threads left some SMs a whole block more than others. Where the
// systems such a block touches would overflow the 48 KB of shared memory a
// launch takes without opting in, the block is cut to whole warps for two,
// three, ... blocks an SM.
// (r, k, threads) come from ops.pairwise.small_schedule(B, N, SM count):
// (2, 4, 928) for 300 systems of N = 200, (2, 8, 608) for 100, (1, 8, 128)
// for one.
//
// Kernel 6 (symmetric, the large-N force). The TPU kernel walks I in grid
// order and carries the j-side reactions in a scratch that step I reads
// from steps < I; a CUDA grid has no order. Here one warp owns one tile pair
// (I, J >= I) of T x T particles, T = 32 r, and only working pairs are
// launched: the triangle of tile pairs is numbered row by row and item q
// goes to warp q % 4 of block q / 4. A lane owns r rows of I and walks the
// columns of each 32-wide sub-tile of J in rotated order (column (lane + s)
// % 32 at step s; the sub-tile is staged twice over so that read is entry
// lane + s): one staged source serves its r rows, and the three column
// sums, added over those r rows in registers, travel from lane to lane by
// one shuffle triple a step, so each column's sum visits the lanes in a
// fixed order and is back in lane c after 32 steps. The warp writes into
// partial[slot, particle, 3], one slot per tile:
//   - its i-side row sums go to partial[J, rows of I];
//   - its j-side column sums, weighted by G*m_i and negated, go to
//     partial[I, rows of J];
//   - the diagonal pair computes the full plane, i side only, and writes
//     partial[I, rows of I].
// Every (slot, row) cell is written by exactly one warp; a second launch
// adds the slots of each particle, eight lanes a column (each every eighth
// slot in ascending order, then the eight sums by xor shuffles: a fixed
// order). Kernel 5's sum_slots_kernel (one thread a column walking every
// slot, an ordinary launch) made kernel 6 2.1 us slower at N = 2,085,
// where 66 slots of 6,255 columns fill 25 blocks, and 1.3 us at N = 10,000.
// r comes from ops.pairwise.sym_schedule(N, SM count): the largest
// of 4, 2, 1 whose triangle gives every SM 16 warps, so N = 10,000 runs
// 3,160 items of 128 x 128 (launch bounds keep it under 80 registers, so
// 24 warps an SM hold them all at once) and N = 2,085 2,211 items of
// 32 x 32.
//
// Both kernels, and kernel 6's slot sum, are launched as programmatic
// dependents (launch_dependent): each may start while the kernel ahead of
// it drains and waits (griddepcontrol.wait) before its first read.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kG = 6.67430e-11f;
constexpr int kTile = 128;      // kernels 3 and 5: receivers and sources a tile
constexpr int kMaxSmallN = 1024;
constexpr int kSymWarps = 4;  // kernel 6: items (warps) a block
constexpr int kSumParts = 8;  // kernel 6's slot sum: lanes a column
constexpr unsigned kFullMask = 0xffffffffu;

// One source as staged in shared memory: (x, y, z, G*m); beyond n a
// zero-mass source at the origin.
__device__ __forceinline__ float4 load_source(const float* __restrict__ pos,
                                              const float* __restrict__ mass,
                                              int j, int n) {
  if (j >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], kG * mass[j]);
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

// 1 / sqrt(x) by the special-function unit, denormals flushed (see the note).
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Source p's pull on receiver q, as add_source (kernel 4, and kernel 6's
// diagonal tile pairs).
__device__ __forceinline__ void add_pull(const float4 p, const float4 q,
                                         float soft2, float& ax, float& ay,
                                         float& az) {
  const float dx = p.x - q.x, dy = p.y - q.y, dz = p.z - q.z;
  const float d2 = dx * dx + dy * dy + dz * dz;
  const float inv_r = rsqrt_ftz(d2 + soft2);
  const float f = d2 > 0.f ? p.w * (inv_r * inv_r * inv_r) : 0.f;
  ax += f * dx;
  ay += f * dy;
  az += f * dz;
}

// Stages `count` consecutive sources (3-float rows, masses) as (x, y, z,
// G*m) in shared memory, the rows by 16-byte loads where they are aligned.
__device__ __forceinline__ void stage_sources(const float* __restrict__ pos,
                                              const float* __restrict__ mass,
                                              int count, float4* dst) {
  float* flat = reinterpret_cast<float*>(dst);
  const int floats = 3 * count;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(pos) & 15) == 0) {
    const float4* rows = reinterpret_cast<const float4*>(pos);
    done = floats / 4 * 4;
    for (int v = threadIdx.x; 4 * v < done; v += blockDim.x) {
      const float4 q = rows[v];
      const float w[4] = {q.x, q.y, q.z, q.w};
      int row = 4 * v / 3, c = 4 * v - 3 * row;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        flat[4 * row + c] = w[u];
        if (++c == 3) {
          c = 0;
          ++row;
        }
      }
    }
  }
  for (int e = done + threadIdx.x; e < floats; e += blockDim.x) {
    flat[4 * (e / 3) + e % 3] = pos[e];
  }
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    flat[4 * e + 3] = kG * mass[e];
  }
}

// Waits for the kernels ahead in the stream to finish (a no-op unless the
// launch let this one start early: launch_dependent).
__device__ __forceinline__ void wait_for_prior_grids() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Kernel 4. Block x takes receiver groups [x * blockDim.x / K, ...) of the
// ensemble (a group: R consecutive receivers of one system, K lanes);
// dynamic shared memory holds every system those groups touch.
template <int R, int K>
__global__ void __launch_bounds__(1024)
pairwise_small_kernel(const float* __restrict__ pos,
                      const float* __restrict__ mass, float* __restrict__ acc,
                      int b, int n, float soft2) {
  extern __shared__ float4 sys_src[];
  constexpr int kUnroll = 8 / R;
  const int per_block = blockDim.x / K;    // receiver groups a block
  const int groups = (n + R - 1) / R;      // receiver groups a system
  const int total = b * groups;            // < 2^31: b, n are capped
  const int first = blockIdx.x * per_block;
  const int last = (first + per_block < total ? first + per_block : total) - 1;
  wait_for_prior_grids();
  const int sys0 = first / groups;
  const int span = last / groups - sys0 + 1;
  stage_sources(pos + static_cast<size_t>(sys0) * n * 3,
                mass + static_cast<size_t>(sys0) * n, span * n, sys_src);
  __syncthreads();
  // A group past the ensemble's end computes the last one again and writes
  // nothing: every lane of a warp takes part in the shuffles.
  const int mine = first + threadIdx.x / K;
  const int g = mine < total ? mine : total - 1;
  const int part = threadIdx.x % K;
  const int sys = g / groups;
  const int i0 = (g - sys * groups) * R;
  const float4* src = sys_src + static_cast<size_t>(sys - sys0) * n;
  float4 self[R];
  float ax[R], ay[R], az[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    self[q] = src[i0 + q < n ? i0 + q : n - 1];
    ax[q] = ay[q] = az[q] = 0.f;
  }
  int j = part;
#pragma unroll kUnroll
  for (int t = 0; t < n / K; ++t, j += K) {
    const float4 p = src[j];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      add_pull(p, self[q], soft2, ax[q], ay[q], az[q]);
    }
  }
  if (j < n) {
    const float4 p = src[j];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      add_pull(p, self[q], soft2, ax[q], ay[q], az[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
#pragma unroll
    for (int off = K / 2; off > 0; off >>= 1) {
      ax[q] += __shfl_xor_sync(kFullMask, ax[q], off);
      ay[q] += __shfl_xor_sync(kFullMask, ay[q], off);
      az[q] += __shfl_xor_sync(kFullMask, az[q], off);
    }
  }
  if (mine >= total || part != 0) return;
  float* out = acc + (static_cast<size_t>(sys) * n + i0) * 3;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (i0 + q < n) {
      out[3 * q] = ax[q];
      out[3 * q + 1] = ay[q];
      out[3 * q + 2] = az[q];
    }
  }
}

// The first row of the triangle of tile pairs that item q falls in: row I
// holds items [I * tiles - I (I - 1) / 2, ...) for J = I .. tiles - 1.
__device__ __forceinline__ long long row_start(long long i, int tiles) {
  return i * tiles - i * (i - 1) / 2;
}

__device__ __forceinline__ void tile_pair(long long q, int tiles, int& ti,
                                          int& tj) {
  const double d = 2.0 * tiles + 1.0;
  long long i = static_cast<long long>((d - sqrt(d * d - 8.0 * q)) * 0.5);
  while (i > 0 && row_start(i, tiles) > q) --i;
  while (i + 1 < tiles && row_start(i + 1, tiles) <= q) ++i;
  ti = static_cast<int>(i);
  tj = static_cast<int>(i + q - row_start(i, tiles));
}

// Kernel 6, first launch. Block x, warp w: item q = 4 x + w of the
// triangle of tile pairs (I, J >= I) of T = 32 R particles; partial is
// (tiles, n, 3).
template <int R>
__global__ void __launch_bounds__(kSymWarps * 32, R == 4 ? 6 : 8)
pairwise_sym_kernel(const float* __restrict__ pos,
                    const float* __restrict__ mass,
                    float* __restrict__ partial, int n, float soft2,
                    int tiles, long long items) {
  constexpr int T = 32 * R;
  // Each 32-wide sub-tile of J twice over, so the rotated read of step s,
  // column (lane + s) % 32, is entry lane + s: no wrap arithmetic.
  __shared__ float4 staged[kSymWarps][R][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long item = static_cast<long long>(blockIdx.x) * kSymWarps + warp;
  wait_for_prior_grids();
  if (item >= items) return;  // the whole warp
  int ti, tj;
  tile_pair(item, tiles, ti, tj);
  float4 (*src)[64] = staged[warp];
  // A row beyond n takes part in the shuffles with zero mass: its column
  // contributions are exactly zero and its row sums are not written.
  float4 self[R];
  float ax[R], ay[R], az[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    src[q][lane] = src[q][lane + 32] =
        load_source(pos, mass, tj * T + lane + 32 * q, n);
    self[q] = load_source(pos, mass, ti * T + lane + 32 * q, n);
    ax[q] = ay[q] = az[q] = 0.f;
  }
  __syncwarp();
  if (ti == tj) {
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      const float4 p = src[t >> 5][t & 31];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        add_pull(p, self[q], soft2, ax[q], ay[q], az[q]);
      }
    }
  } else {
    const int next = (lane + 1) & 31;
    for (int c = 0; c < R; ++c) {
      // At step s this lane holds the sums of column 32 c + (lane + s) % 32.
      float cx = 0.f, cy = 0.f, cz = 0.f;
      const float4* col = &src[c][lane];
#pragma unroll 16
      for (int s = 0; s < 32; ++s) {
        const float4 p = col[s];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float dx = p.x - self[q].x, dy = p.y - self[q].y,
                      dz = p.z - self[q].z;
          const float d2 = dx * dx + dy * dy + dz * dz;
          const float inv_r = rsqrt_ftz(d2 + soft2);
          const float r3 = d2 > 0.f ? inv_r * inv_r * inv_r : 0.f;
          const float fj = p.w * r3, gi = self[q].w * r3;
          ax[q] += fj * dx;
          ay[q] += fj * dy;
          az[q] += fj * dz;
          cx += gi * dx;
          cy += gi * dy;
          cz += gi * dz;
        }
        cx = __shfl_sync(kFullMask, cx, next);
        cy = __shfl_sync(kFullMask, cy, next);
        cz = __shfl_sync(kFullMask, cz, next);
      }
      // After 32 steps the sums of column 32 c + lane are back in this lane.
      const int j = tj * T + 32 * c + lane;
      if (j < n) {
        float* out = partial + (static_cast<size_t>(ti) * n + j) * 3;
        out[0] = -cx;
        out[1] = -cy;
        out[2] = -cz;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int row = ti * T + lane + 32 * q;
    if (row < n) {
      float* out = partial + (static_cast<size_t>(tj) * n + row) * 3;
      out[0] = ax[q];
      out[1] = ay[q];
      out[2] = az[q];
    }
  }
}

// Kernel 6, second launch: acc[c] = sum over slots of partial[slot, c];
// cols = 3 n. Lane p of a column's kSumParts adds slots p, p + kSumParts,
// ... in order, then their sums meet by xor shuffles.
__global__ void __launch_bounds__(256)
sym_sum_kernel(const float* __restrict__ partial, float* __restrict__ acc,
               int slots, int cols) {
  wait_for_prior_grids();
  const long long c =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
      kSumParts;
  const int part = threadIdx.x % kSumParts;
  float s = 0.f;
  if (c < cols) {
#pragma unroll 8
    for (int k = part; k < slots; k += kSumParts) {
      s += partial[static_cast<size_t>(k) * cols + c];
    }
  }
#pragma unroll
  for (int off = kSumParts / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(kFullMask, s, off);
  }
  if (c < cols && part == 0) acc[c] = s;
}

// Kernel 5, second launch: acc[c] = sum over slots of partial[slot, c], in
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
// Schedule: kernel 6's before its redesign. One block per tile pair
// (I, J >= I) of 128 x 128 writes partial[J, rows of I] (i side) and
// partial[I, rows of J] (j side; the diagonal block only the former, over
// its whole plane), one writer per
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

// Launches `kernel` so that it may start while the kernels ahead of it in
// the stream finish (programmatic dependent launch); the kernel itself
// calls wait_for_prior_grids() before it reads anything they write. This
// hides a launch's latency behind its predecessor's tail.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned blocks,
                             unsigned threads, size_t smem, cudaStream_t s,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// Plain C entry points, called through ctypes. pos (b, n, 3), mass (b, n),
// acc (b, n, 3) float32, contiguous, on one device; soft2 = eps^2. The
// symmetric forms (kernels 6 and 5) take one system (n, 3) and a
// (slots, n, 3) float32 scratch, one slot per tile. Kernel 4 and 6 take
// their schedule (ops/pairwise.py). They launch on `stream` and return
// cudaGetLastError() (0 on success).

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
                                    int r, int k, int threads, void* stream) {
  if (b < 0 || n < 0 || b > 65535 || n > kMaxSmallN || threads % 32 != 0 ||
      threads < 32 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return 0;
  // The most systems one block's groups touch: what it stages. The launch
  // refuses more than the 48 KB a kernel gets without opting in.
  const int groups = (n + r - 1) / r;
  const int per_block = threads / k;
  const int span = std::min(b, (groups + per_block - 2) / groups + 1);
  const size_t smem = static_cast<size_t>(span) * n * sizeof(float4);
  const unsigned blocks = (b * groups + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(const float*, const float*, float*, int, int, float) =
      r == 1 ? (k == 1 ? pairwise_small_kernel<1, 1>
                : k == 2 ? pairwise_small_kernel<1, 2>
                : k == 4 ? pairwise_small_kernel<1, 4>
                : k == 8 ? pairwise_small_kernel<1, 8> : nullptr)
    : r == 2 ? (k == 1 ? pairwise_small_kernel<2, 1>
                : k == 2 ? pairwise_small_kernel<2, 2>
                : k == 4 ? pairwise_small_kernel<2, 4>
                : k == 8 ? pairwise_small_kernel<2, 8> : nullptr)
             : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_dependent(kernel, blocks, threads, smem, s,
                                           pos, mass, acc, b, n, soft2));
}

// Kernel 6: pos is one system (n, 3), partial a (ceil(n / (32 r)), n, 3)
// float32 scratch, r = rows_per_lane (1, 2 or 4).
extern "C" int nbody_pairwise_symmetric(const float* pos, const float* mass,
                                        float* partial, float* acc, int n,
                                        float soft2, int rows_per_lane,
                                        void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  void (*kernel)(const float*, const float*, float*, int, float, int,
                 long long) =
      rows_per_lane == 1   ? pairwise_sym_kernel<1>
      : rows_per_lane == 2 ? pairwise_sym_kernel<2>
      : rows_per_lane == 4 ? pairwise_sym_kernel<4> : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = 32 * rows_per_lane;
  const int tiles = (n + tile - 1) / tile;
  const long long items = static_cast<long long>(tiles) * (tiles + 1) / 2;
  const long long grid = (items + kSymWarps - 1) / kSymWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_dependent(kernel, static_cast<unsigned>(grid),
                                     kSymWarps * 32, 0, s, pos, mass, partial,
                                     n, soft2, tiles, items);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = 3 * n;
  const unsigned sum_blocks = static_cast<unsigned>(
      (static_cast<long long>(cols) * kSumParts + 255) / 256);
  err = launch_dependent(sym_sum_kernel, sum_blocks, 256, 0, s,
                         static_cast<const float*>(partial), acc, tiles, cols);
  return static_cast<int>(err);
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
