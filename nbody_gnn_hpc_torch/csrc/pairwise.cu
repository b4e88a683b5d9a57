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
//             done as tensor-core products (its note is above its code).
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
// Kernel 3 (tiled, the public all-pairs form; the oracle of kernel 6). The
// work is flattened over the ensemble as in kernel 4: a receiver group is r
// consecutive receivers of one system (register tiling: one staged source
// serves r pairs), and k lanes share a group. The k lanes are k / KL slices
// of KL <= 32 lanes. The block stages the sources of every system its
// groups touch through shared memory as float4 (x, y, z, G*m), `tile`
// sources of each system at a time (the last tile filled with zero-mass
// sources to a multiple of k); slice s of a group takes the s-th of k / KL
// equal parts of each tile, and its lane p the entries p, p + KL, ... of
// that part in ascending order. A slice's KL partial sums are added by xor
// shuffles, then the slices' sums in slice order through shared memory: a
// fixed order. Two tile buffers: the loads of tile t + 1 are issued into
// registers before tile t's pairs and stored after them, so one barrier a
// tile suffices and the copy overlaps the arithmetic. (r, k, threads, tile)
// come from ops.pairwise.tiled_schedule(B, N, SM count): the largest r of
// 4, 2, 1 and the least k that give every SM 16 warps with at least 32
// sources a lane, and blocks sized so that one block an SM holds the whole
// grid where it fits: (4, 32, 608, 1216) at N = 10,000, 132 blocks of 19
// warps; (1, 64, 1024, 1536) at N = 2,085, 131 blocks of 32. Its form
// before (one thread a receiver, blocks of 128) left 53 of 132 SMs idle at
// N = 10,000 and ran each receiver's sources as one chain of dependent adds.
//
// What bounds kernels 3, 4 and 6 on an H100. The card's float32 rate (67
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
// pairs, ~21.5 slots each with the loads and shuffles; bound 18.7 us).
// Kernel 3 computes every ordered pair, the self pair included: 1e8 at
// N = 10,000 at 16.25 slots (the load shared by r = 4 receivers), ~48.6 us
// (bound 26.9 us), and 4.35e6 at N = 2,085 at 17 slots (r = 1), ~2.2 us
// (bound 1.2 us); staging and the sums' shuffles add ~1 % and ~15 %.
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
// order). A sum of one thread a column walking every slot, an ordinary
// launch, made kernel 6 2.1 us slower at N = 2,085, where 66 slots of
// 6,255 columns fill 25 blocks, and 1.3 us at N = 10,000; kernel 5 takes
// this one too.
// r comes from ops.pairwise.sym_schedule(N, SM count): the largest
// of 4, 2, 1 whose triangle gives every SM 16 warps, so N = 10,000 runs
// 3,160 items of 128 x 128 (launch bounds keep it under 80 registers, so
// 24 warps an SM hold them all at once) and N = 2,085 2,211 items of
// 32 x 32.
//
// Every kernel here, the slot sum and kernel 5's centring included, is
// launched as a programmatic dependent (launch_dependent): each may start
// while the kernel ahead of it drains and waits (griddepcontrol.wait)
// before its first read.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kG = 6.67430e-11f;
constexpr int kMaxSmallN = 1024;
constexpr int kSymWarps = 4;  // kernel 6: items (warps) a block
constexpr int kSumParts = 8;  // kernel 6's slot sum: lanes a column
constexpr int kTiledStage = 2;  // kernel 3: sources a thread stages a tile
constexpr int kTiledSmem = 48 * 1024;  // kernel 3: what it takes unasked
constexpr unsigned kFullMask = 0xffffffffu;

// One source as staged in shared memory: (x, y, z, G*m); beyond n a
// zero-mass source at the origin.
__device__ __forceinline__ float4 load_source(const float* __restrict__ pos,
                                              const float* __restrict__ mass,
                                              int j, int n) {
  if (j >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], kG * mass[j]);
}

// 1 / sqrt(x) by the special-function unit, denormals flushed (see the note).
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Adds source p's pull on receiver q: f = G m_j / r^3, selected to zero for
// a coincident pair, times the displacement (kernels 3 and 4, and kernel
// 6's diagonal tile pairs).
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

// Kernel 3: entry e of a staged tile, source j0 + e % cnt of system
// sys0 + e / cnt (zero-mass beyond n), and its slot in the buffer, `tile`
// entries a system.
__device__ __forceinline__ float4 tiled_entry(const float* __restrict__ pos,
                                              const float* __restrict__ mass,
                                              int sys0, int span, int n,
                                              int j0, int cnt, int tile,
                                              int e, int& slot) {
  const int s = span == 1 ? 0 : e / cnt;
  const int j = e - s * cnt;
  slot = s * tile + j;
  const size_t sys = static_cast<size_t>(sys0) + s;
  return load_source(pos + sys * n * 3, mass + sys * n, j0 + j, n);
}

// Kernel 3. Block x takes receiver groups [x * blockDim.x / k, ...) of the
// ensemble (a group: R consecutive receivers of one system, k = KL * slices
// lanes); dynamic shared memory holds two tile buffers of `tile` sources of
// every system those groups touch.
template <int R, int KL>
__global__ void __launch_bounds__(R == 4 ? 640 : 1024)
pairwise_tiled_kernel(const float* __restrict__ pos,
                      const float* __restrict__ mass, float* __restrict__ acc,
                      int b, int n, float soft2, int k, int tile) {
  extern __shared__ float4 tiled_src[];
  constexpr int kUnroll = 8 / R;
  const int slices = k / KL;
  const int per_block = blockDim.x / k;    // receiver groups a block
  const int groups = (n + R - 1) / R;      // receiver groups a system
  const int total = b * groups;            // < 2^31: checked at the launch
  const int first = blockIdx.x * per_block;
  const int last = (first + per_block < total ? first + per_block : total) - 1;
  const int sys0 = first / groups;
  const int span = last / groups - sys0 + 1;
  // Thread t: slice t / (per_block KL), then group, then lane within KL.
  const int slice = threadIdx.x / (per_block * KL);
  const int local = threadIdx.x / KL - slice * per_block;
  const int part = threadIdx.x % KL;
  // A group past the ensemble's end computes the last one again and writes
  // nothing: every lane of a warp takes part in the shuffles.
  const int mine = first + local;
  const int g = mine < total ? mine : total - 1;
  const int sys = g / groups;
  const int i0 = (g - sys * groups) * R;
  wait_for_prior_grids();
  const float* spos = pos + static_cast<size_t>(sys) * n * 3;
  float4 self[R];
  float ax[R], ay[R], az[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = i0 + q < n ? i0 + q : n - 1;
    self[q] = make_float4(spos[3 * i], spos[3 * i + 1], spos[3 * i + 2], 0.f);
    ax[q] = ay[q] = az[q] = 0.f;
  }
  float4* cur = tiled_src;
  float4* nxt = tiled_src + span * tile;
  {
    const int cnt = (min(tile, n) + k - 1) / k * k;
    for (int e = threadIdx.x; e < span * cnt; e += blockDim.x) {
      int slot;
      const float4 v =
          tiled_entry(pos, mass, sys0, span, n, 0, cnt, tile, e, slot);
      cur[slot] = v;
    }
  }
  __syncthreads();
  const int own = (sys - sys0) * tile;  // this group's system in a buffer
  for (int j0 = 0; j0 < n; j0 += tile) {
    // This tile's staged sources a system, and the next one's.
    const int cnt = (min(tile, n - j0) + k - 1) / k * k;
    const int j1 = j0 + tile;
    const int next_cnt = j1 < n ? (min(tile, n - j1) + k - 1) / k * k : 0;
    float4 ahead[kTiledStage];
    int slot[kTiledStage];
#pragma unroll
    for (int u = 0; u < kTiledStage; ++u) {
      const int e = threadIdx.x + u * blockDim.x;
      slot[u] = -1;
      ahead[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < span * next_cnt) {
        ahead[u] = tiled_entry(pos, mass, sys0, span, n, j1, next_cnt, tile,
                               e, slot[u]);
      }
    }
    const float4* src = cur + own + slice * (cnt / slices) + part;
    const int steps = cnt / k;
#pragma unroll kUnroll
    for (int t = 0; t < steps; ++t) {
      const float4 p = src[t * KL];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        add_pull(p, self[q], soft2, ax[q], ay[q], az[q]);
      }
    }
#pragma unroll
    for (int u = 0; u < kTiledStage; ++u) {
      if (slot[u] >= 0) nxt[slot[u]] = ahead[u];
    }
    __syncthreads();
    float4* done = cur;
    cur = nxt;
    nxt = done;
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
#pragma unroll
    for (int off = KL / 2; off > 0; off >>= 1) {
      ax[q] += __shfl_xor_sync(kFullMask, ax[q], off);
      ay[q] += __shfl_xor_sync(kFullMask, ay[q], off);
      az[q] += __shfl_xor_sync(kFullMask, az[q], off);
    }
  }
  if (slices > 1) {
    // The loop's last barrier freed the buffers: slices 1.. leave their
    // sums there, and slice 0 adds them in slice order.
    float* red = reinterpret_cast<float*>(tiled_src);
    if (slice > 0 && part == 0) {
      float* out = red + ((slice - 1) * per_block + local) * 3 * R;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        out[3 * q] = ax[q];
        out[3 * q + 1] = ay[q];
        out[3 * q + 2] = az[q];
      }
    }
    __syncthreads();
    if (slice == 0 && part == 0) {
      for (int s = 1; s < slices; ++s) {
        const float* in = red + ((s - 1) * per_block + local) * 3 * R;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          ax[q] += in[3 * q];
          ay[q] += in[3 * q + 1];
          az[q] += in[3 * q + 2];
        }
      }
    }
  }
  if (mine >= total || slice != 0 || part != 0) return;
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

// Kernel 5 (symmetric, tensor-core moments). The TPU kernel moved the mass
// weighting and the six reductions of kernel 6 onto the matrix unit through
// the moment decomposition: with positions centred by their mean and
// W_j = G m_j [1, x_j, y_j, z_j],
//   a_i = sum_j s_ij W_j[1:4] - x_i sum_j s_ij W_j[0],  s = (d^2 + eps^2)^-3/2,
// so a tile pair's i side is M = s @ W_J and its j side (Newton's third law)
// Mj = W_I^T @ s, a_j = Mj[1:4] - x_j Mj[0]. On the TPU it was a measured
// negative result, dispatched by nothing: the two terms of the difference
// are |x| / |d| times the force, so rounding is amplified for close pairs.
// The port keeps that status: a public function that no entry point calls.
//
// Three launches, each a programmatic dependent: centre_kernel (one block:
// the float32 mean of the positions in a fixed order), the pair pass, and
// kernel 6's slot sum. The pair pass takes the
// triangle of tile pairs (I, J >= I) of T x T particles, numbered row by
// row as kernel 6's, one block each; T (128, 64 or 32) comes from
// ops.pairwise.mma_schedule(N, SM count): the largest whose triangle gives
// every SM 16 warps, so N = 10,000 runs 3,160 pairs of 128 (8 warps each)
// and N = 2,085 561 pairs of 64 (4 warps). The block stages both tiles,
// centred (a ragged tile filled with zero-mass particles at the origin),
// and W_J as B fragments of the m16n8k8 TF32 product, W_hi in columns 0-3
// and W_lo in 4-7. Warp w owns rows 16 w .. 16 w + 15 of I and walks J in
// 16-column blocks:
//   - its lanes build the 16 x 16 block of s directly in the A fragment's
//     layout (zero where d^2 == 0, so a coincident pair and the self pair
//     drop out) and split each value on the spot into hi = tf32(s) and
//     lo = s - hi: no s-plane in shared memory;
//   - the i side, M of the strip's rows, takes two k steps a block;
//   - the j side needs the block transposed, the A fragment of s^T (rows
//     of J), which takes s's other index from the lane's high bits (g).
//     The lanes move s by shuffles and split it again. Three forms were
//     built and timed on the card (PERF.md section 6): rebuild s in that
//     layout (s_ij = s_ji, bit for bit), pass hi and lo once through a
//     warp-private swizzled plane in shared memory (8 stores and 8 loads of
//     64 bits a lane a block, no bank conflicts), or the shuffles. The
//     shuffles won at N = 10,000 and 2,085 and are the one kept: a shuffle
//     a value (each source lane sends the column its one reader wants; two
//     rounds, a select on each side) costs 3 issue slots and the split 3,
//     against the rebuild's 15 and a second rsqrt, and keeps shared memory
//     free for the J loads, which the plane's 32 wavefronts a block crowd
//     out;
//   - the j side's sums of J block b are whole after its two k steps; the
//     accumulator fragment goes to shared memory, and after the walk each
//     thread adds one element of it over the strips in order.
// The centring in the kernel's own first launch measured faster than the
// torch mean and subtraction it replaced, at both sizes (PERF.md section 6).
// The i side writes partial[J, rows of I], the j side partial[I, rows of
// J], the diagonal pair (full plane, i side only) partial[I, rows of I]:
// one writer per (slot, row), no float atomics, reruns bit-identical.
//
// Precision: 3xTF32. A TF32 operand keeps 10 bits of mantissa, about three
// decimal digits, and the moment form multiplies that error by |x| / |d|:
// one TF32 pass misses the float32 tolerance of the JAX package's test by
// orders of magnitude. W is split as hi = tf32(W), lo = tf32(W - hi), and
// each k step's products lo_s hi_W, hi_s hi_W (columns 0-3) and hi_s lo_W
// (columns 4-7; the packing takes two instructions for the three) go into
// a zeroed fragment, which float32 adds then fold into the running sums;
// columns 4-7 are added to 0-3 once, at the end. The running sums stay out
// of the tensor core: its float32 accumulation does not round as float32
// adds do, and carrying the sums through every instruction of a row left
// one particle of an N = 2,085 system 1.6 times the tolerance from the
// plain version on the card. What the split drops is amplified where it
// differs between W's columns: lo_s lo_W, ~2^-22 of a product with s
// rounded to nearest; truncating s instead doubles it, which a trial on
// the card showed against the float64 sum near N = 10,000. The error of s
// itself (lo_s read to TF32) is not: s_ij multiplies both terms of the
// difference alike. The kernel stays nearer a float64 evaluation than the
// float32 plain version does.
//
// Bounds on an H100. The function's work is kernel 6's (25 float32
// operations and one rsqrt per unordered pair): at N = 10,000, 19 us. The
// issue floor of this design, per 16 x 16 block a warp
// (256 values of s, 8 a lane): 96 slots to build s (12 a value: 3 FADD,
// FMUL + 2 FFMA, FADD, MUFU.RSQ, 2 FMUL, FSETP + FSEL), 24 to split it, 6
// loads (J, W_J), 12 for the i side's two k steps (4 HMMA, 8 FADD), 24 to
// move s (8 SHFL, 16 selects), 24 to split it again, 8 for the j side (4
// HMMA, 4 FADD) and a store: ~195 slots, 0.76 a pair. At 4 x 132 warp
// instructions a clock and 1.98 GHz, N = 10,000 (3,081 off-diagonal and
// 79 diagonal pairs of 128) is ~37 us; the rsqrt at 16 a clock an SM
// (12.4 us) and the 1.6e6 HMMA (~12 us at half the dense TF32 rate) run
// beside it; the compiled code adds moves, predicates and addresses. The
// slot sum adds kernel 6's ~4 us at N = 10,000, ~2 us at N = 2,085.
constexpr int kCentreThreads = 768;  // a multiple of 3: thread k sums x, y or z

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

// s as the A operand of the 3xTF32 products: hi = tf32(s), rounded to
// nearest (ties away from zero, as cvt.rna for a finite s) by two integer
// operations, and lo = s - hi, which the tensor core reads to TF32. Rounding
// halves lo against truncation, and with it the dropped product lo_s lo_W,
// which differs between W's columns and so is amplified (see the note).
__device__ __forceinline__ void split_s(float s, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(s) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(s - __uint_as_float(hi));
}

// s = (d^2 + eps^2)^-3/2 of particles a (of I) and b (of J), zero where
// d^2 == 0.
__device__ __forceinline__ float pair_s(const float4 a, const float4 b,
                                        float soft2) {
  const float dx = b.x - a.x, dy = b.y - a.y, dz = b.z - a.z;
  const float d2 = dx * dx + dy * dy + dz * dz;
  const float r = rsqrt_ftz(d2 + soft2);
  return d2 > 0.f ? r * r * r : 0.f;
}

// c += a @ b for one m16n8k8 tile: a 16 x 8 (row), b 8 x 8 (col), TF32 in,
// float32 accumulators. Fragment layout: lane = 4 g + t holds A (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4), B (t, g), (t + 4, g) and
// C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += (or, kFresh, =) two k steps of s @ W in 3xTF32: A = (ah, al),
// B = [W_hi | W_lo] (bw) and [W_hi | 0] (bwh), each step's small terms
// first into a zeroed fragment (both steps' first products are issued
// before either's second, which waits for the first).
template <bool kFresh = false>
__device__ __forceinline__ void moment_steps(float (&acc)[4],
                                             const uint32_t (&ah)[2][4],
                                             const uint32_t (&al)[2][4],
                                             const uint32_t (&bw)[2][2],
                                             const uint32_t (&bwh)[2][2]) {
  float d[2][4] = {};
#pragma unroll
  for (int k = 0; k < 2; ++k) mma_tf32(d[k], al[k], bwh[k]);
#pragma unroll
  for (int k = 0; k < 2; ++k) mma_tf32(d[k], ah[k], bw[k]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    acc[q] = (kFresh ? d[0][q] : acc[q] + d[0][q]) + d[1][q];
  }
}

// Kernel 5, first launch: centre[0..2] = the mean of the n rows of pos.
// Thread k adds, in order, every kCentreThreads-th 16-byte group of the 3 n
// floats (where pos is 16-byte aligned, else every such float): as
// kCentreThreads is a multiple of 3, its floats' coordinates are k % 3,
// k + 1, ... (mod 3) in every group, kept in three sums. A tree over the
// threads then adds each coordinate's sums: a fixed order.
__global__ void __launch_bounds__(kCentreThreads)
centre_kernel(const float* __restrict__ pos, float* __restrict__ centre,
              int n) {
  __shared__ float sums[3][kCentreThreads];
  wait_for_prior_grids();
  const int k = threadIdx.x;
  float a[3] = {0.f, 0.f, 0.f};  // coordinates k, k + 1, k + 2 (mod 3)
  const int floats = 3 * n;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(pos) & 15) == 0) {
    const float4* groups = reinterpret_cast<const float4*>(pos);
    const int count = floats / 4;
    done = 4 * count;
    constexpr int kAhead = 8;  // loads in flight a thread
    int v = k;
    for (; v + (kAhead - 1) * kCentreThreads < count;
         v += kAhead * kCentreThreads) {
      float4 f[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) f[i] = groups[v + i * kCentreThreads];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        a[0] += f[i].x;
        a[1] += f[i].y;
        a[2] += f[i].z;
        a[0] += f[i].w;
      }
    }
    for (; v < count; v += kCentreThreads) {
      const float4 f = groups[v];
      a[0] += f.x;
      a[1] += f.y;
      a[2] += f.z;
      a[0] += f.w;
    }
  }
  // The rest one float at a time: float e = done + k (mod kCentreThreads)
  // has coordinate (done + k) % 3, a[done % 3]'s.
  for (int e = done + k; e < floats; e += kCentreThreads) {
    a[done % 3] += pos[e];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) sums[(k + c) % 3][k] = a[c];
  __syncthreads();
  constexpr int kThird = kCentreThreads / 3;  // a power of two
  if (k < kThird) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sums[c][k] += sums[c][k + kThird];
      sums[c][k] += sums[c][k + 2 * kThird];
    }
  }
  __syncthreads();
#pragma unroll
  for (int stride = kThird / 2; stride > 0; stride /= 2) {
    if (k < stride) {
#pragma unroll
      for (int c = 0; c < 3; ++c) sums[c][k] += sums[c][k + stride];
    }
    __syncthreads();
  }
  if (k < 3) centre[k] = sums[k][0] / static_cast<float>(n);
}

// Kernel 5, the pair pass. Block q: item q of the triangle of tile pairs
// (I, J >= I) of T particles; 2 T threads, warp w the rows 16 w .. 16 w + 15
// of I. centre: the mean to subtract (centre_kernel's); partial is
// (tiles, n, 3).
template <int T>
__global__ void __launch_bounds__(2 * T, T == 128 ? 2 : 4)
pairwise_mma_kernel(const float* __restrict__ pos,
                    const float* __restrict__ mass,
                    const float* __restrict__ centre,
                    float* __restrict__ partial, int n, float soft2,
                    int tiles) {
  constexpr int kWarps = T / 16;  // strips of I; also 16-column blocks of J
  constexpr int kSteps = T / 8;   // k steps of a tile
  __shared__ float4 pos_i[T], pos_j[T];  // centred (x, y, z), G m
  // W_J's B fragments: k step K, lane 4 c + t holds rows t, t + 4 of column
  // c of [W_hi | W_lo] (c < 4: W_hi[c]; c >= 4: W_lo[c - 4]), then of
  // [W_hi | 0].
  __shared__ float4 frag_j[kSteps][32];
  // The j side's sums of each strip and J block: the whole accumulator
  // fragment ([kWarps][kWarps][32], 2 T a strip).
  __shared__ float4 red[kWarps * 2 * T];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  int ti, tj;
  tile_pair(blockIdx.x, tiles, ti, tj);
  const bool diag = ti == tj;
  {
    // Threads 0 .. T-1 stage I's particles, T .. 2T-1 J's. A row beyond n
    // is a zero-mass particle at the origin: its W is zero, so its s values
    // (finite: at most eps^-3) add nothing, and its result is not written.
    const bool j_half = tid >= T;
    const int r = j_half ? tid - T : tid;
    const int p = (j_half ? tj : ti) * T + r;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    wait_for_prior_grids();
    if (p < n) {
      q = make_float4(pos[3 * p] - centre[0], pos[3 * p + 1] - centre[1],
                      pos[3 * p + 2] - centre[2], kG * mass[p]);
    }
    (j_half ? pos_j : pos_i)[r] = q;
    if (j_half) {
      float* f = reinterpret_cast<float*>(frag_j[r >> 3]);
      const int at = 4 * (r & 3) + ((r >> 2) & 1);
      const float w[4] = {q.w, q.w * q.x, q.w * q.y, q.w * q.z};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t hi, lo;
        split_tf32(w[c], hi, lo);
        f[16 * c + at] = f[16 * c + at + 2] = __uint_as_float(hi);
        f[16 * (c + 4) + at] = __uint_as_float(lo);
        f[16 * (c + 4) + at + 2] = 0.f;
      }
    }
  }
  __syncthreads();
  const float4 pi[2] = {pos_i[16 * warp + g], pos_i[16 * warp + g + 8]};
  // The j side's k rows 8 l + 4 v + t of the strip: W_I's B fragments
  // (column g, made here once).
  const bool low = g < 4;  // this lane's B column is one of W_hi's
  uint32_t bi[2][2], bih[2][2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const float4 q = pos_i[16 * warp + 8 * l + 4 * v + t];
      const int c = g & 3;
      const float w = c == 0 ? q.w
                             : q.w * (c == 1 ? q.x : c == 2 ? q.y : q.z);
      uint32_t hi, lo;
      split_tf32(w, hi, lo);
      bi[l][v] = low ? hi : lo;
      bih[l][v] = low ? hi : 0u;
    }
  }
  float ci[4] = {0.f, 0.f, 0.f, 0.f};
  // The shuffles' sources (below).
  const bool e = g >= 4;
  const int src = 16 * e + 4 * t + (g & 3);
#pragma unroll
  for (int b = 0; b < kWarps; ++b) {
    // s of rows g + 8 h of the strip and columns 16 b + t + 4 u of J.
    float s[2][4];
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 pj = pos_j[16 * b + t + 4 * u];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][u] = pair_s(pi[h], pj, soft2);
        split_s(s[h][u], hi[h][u], lo[h][u]);
      }
    }
    {
      // k step k: columns 16 b + 8 k .. + 7.
      uint32_t ah[2][4], al[2][4], bw[2][2], bwh[2][2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // A (g, t), (g + 8, t), (g, t + 4), ...
          ah[k][q] = hi[q & 1][2 * k + (q >> 1)];
          al[k][q] = lo[q & 1][2 * k + (q >> 1)];
        }
        const float4 f = frag_j[2 * b + k][lane];
        bw[k][0] = __float_as_uint(f.x);
        bw[k][1] = __float_as_uint(f.y);
        bwh[k][0] = __float_as_uint(f.z);
        bwh[k][1] = __float_as_uint(f.w);
      }
      moment_steps(ci, ah, al, bw, bwh);
    }
    if (diag) continue;  // the whole block: the full plane, i side only
    // The j side's A fragments of s^T, k step l: [l][2 v + h] = s of strip
    // row 8 l + 4 v + t and J column 16 b + g + 8 h; its sums for J block b
    // are whole after these two k steps and go to red.
    uint32_t jh[2][4], jl[2][4];
    // Value (l, v, h) is s[l][g / 4 + 2 h] of lane 16 v + 4 t + g % 4.
    // Round one brings v = e = g / 4 from lane src and round two v = 1 - e
    // from src ^ 16: each source lane has one reader a round and sends it
    // its column.
#pragma unroll
    for (int l = 0; l < 2; ++l) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sa = e ? s[l][1 + 2 * h] : s[l][2 * h];
        const float sb = e ? s[l][2 * h] : s[l][1 + 2 * h];
        const float ra = __shfl_sync(kFullMask, sa, src);
        const float rb = __shfl_sync(kFullMask, sb, src ^ 16);
        split_s(e ? rb : ra, jh[l][h], jl[l][h]);
        split_s(e ? ra : rb, jh[l][2 + h], jl[l][2 + h]);
      }
    }
    float cj[4];
    moment_steps<true>(cj, jh, jl, bi, bih);
    red[warp * 2 * T + 32 * b + lane] =
        make_float4(cj[0], cj[1], cj[2], cj[3]);
  }
  // Columns 4-7 hold the W_lo parts of columns 0-3: lane t + 2 adds into
  // lane t. Lane t = 0 then holds M[0:2] of rows g and g + 8, lane 1
  // M[2:4]; they trade halves so that lane 0 has row g, lane 1 row g + 8.
#pragma unroll
  for (int q = 0; q < 4; ++q) ci[q] += __shfl_xor_sync(kFullMask, ci[q], 2);
  const bool odd = t & 1;
  const float x0 = __shfl_xor_sync(kFullMask, odd ? ci[0] : ci[2], 1);
  const float x1 = __shfl_xor_sync(kFullMask, odd ? ci[1] : ci[3], 1);
  if (t < 2) {
    const int p = ti * T + 16 * warp + g + 8 * t;
    if (p < n) {
      const float m0 = odd ? x0 : ci[0], m1 = odd ? x1 : ci[1];
      const float m2 = odd ? ci[2] : x0, m3 = odd ? ci[3] : x1;
      const float4 q = odd ? pi[1] : pi[0];
      float* out = partial + (static_cast<size_t>(tj) * n + p) * 3;
      out[0] = m1 - q.x * m0;
      out[1] = m2 - q.y * m0;
      out[2] = m3 - q.z * m0;
    }
  }
  if (diag) return;  // the whole block
  __syncthreads();  // every strip's sums are in red
  // Thread tid adds element tid (J block tid / 32, lane tid % 32) of the
  // strips' fragments in order, then, as the i side above, lanes t + 2
  // into t and lanes 0, 1 trade halves: lane 0 ends with row g of the
  // block, lane 1 with row g + 8.
  float f[4];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float4 o = red[w * 2 * T + tid];
    f[0] = w ? f[0] + o.x : o.x;
    f[1] = w ? f[1] + o.y : o.y;
    f[2] = w ? f[2] + o.z : o.z;
    f[3] = w ? f[3] + o.w : o.w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) f[q] += __shfl_xor_sync(kFullMask, f[q], 2);
  const float y0 = __shfl_xor_sync(kFullMask, odd ? f[0] : f[2], 1);
  const float y1 = __shfl_xor_sync(kFullMask, odd ? f[1] : f[3], 1);
  const int row = 16 * (tid >> 5) + g + 8 * t;
  if (t < 2 && tj * T + row < n) {
    const float m0 = odd ? y0 : f[0], m1 = odd ? y1 : f[1];
    const float m2 = odd ? f[2] : y0, m3 = odd ? f[3] : y1;
    const float4 q = pos_j[row];
    float* out = partial + (static_cast<size_t>(ti) * n + tj * T + row) * 3;
    out[0] = m1 - q.x * m0;
    out[1] = m2 - q.y * m0;
    out[2] = m3 - q.z * m0;
  }
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
// (slots, n, 3) float32 scratch, one slot per tile. Each kernel takes its
// schedule (ops/pairwise.py). They launch on `stream` and return
// cudaGetLastError() (0 on success).

using TiledKernel = void (*)(const float*, const float*, float*, int, int,
                            float, int, int);

template <int R>
TiledKernel tiled_kernel(int kl) {
  return kl == 1    ? pairwise_tiled_kernel<R, 1>
         : kl == 2  ? pairwise_tiled_kernel<R, 2>
         : kl == 4  ? pairwise_tiled_kernel<R, 4>
         : kl == 8  ? pairwise_tiled_kernel<R, 8>
         : kl == 16 ? pairwise_tiled_kernel<R, 16>
         : kl == 32 ? pairwise_tiled_kernel<R, 32> : nullptr;
}

// Kernel 3: r receivers a group, k lanes a group (a power of two; KL =
// min(k, 32) of them in a warp), `tile` sources of each system staged at a
// time (a multiple of k); ops.pairwise.tiled_schedule.
extern "C" int nbody_pairwise_tiled(const float* pos, const float* mass,
                                    float* acc, int b, int n, float soft2,
                                    int r, int k, int threads, int tile,
                                    void* stream) {
  if (b < 0 || n < 0 || b > 65535 || k < 1 || (k & (k - 1)) != 0 ||
      threads % 32 != 0 || threads < 32 || threads > (r == 4 ? 640 : 1024) ||
      threads % k != 0 || tile < k || tile % k != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return 0;
  const int kl = std::min(k, 32);
  const TiledKernel kernel = r == 1   ? tiled_kernel<1>(kl)
                             : r == 2 ? tiled_kernel<2>(kl)
                             : r == 4 ? tiled_kernel<4>(kl) : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (n + r - 1) / r;
  const long long total = groups * b;
  if (total + threads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The most systems one block's groups touch; each thread stages at most
  // kTiledStage sources of a tile.
  const int per_block = threads / k;
  const long long span =
      std::min<long long>(b, (groups + per_block - 2) / groups + 1);
  if (span * tile > static_cast<long long>(kTiledStage) * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = std::max<size_t>(
      2 * span * tile * sizeof(float4),
      static_cast<size_t>(threads / kl) * 3 * r * sizeof(float));
  if (smem > static_cast<size_t>(kTiledSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((total + per_block - 1) /
                                                per_block);
  return static_cast<int>(launch_dependent(
      kernel, blocks, threads, smem, static_cast<cudaStream_t>(stream), pos,
      mass, acc, b, n, soft2, k, tile));
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

using MmaKernel = void (*)(const float*, const float*, const float*, float*,
                          int, float, int);

// Kernel 5: pos is one system (n, 3), partial a (ceil(n / tile), n, 3)
// float32 scratch as for the symmetric form; tile 32, 64 or 128
// (ops.pairwise.mma_schedule); centre 3 floats of scratch that the first
// launch fills with the positions' mean.
extern "C" int nbody_pairwise_symmetric_mma(const float* pos, const float* mass,
                                            float* partial, float* centre,
                                            float* acc, int n, float soft2,
                                            int tile, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const MmaKernel kernel = tile == 32    ? pairwise_mma_kernel<32>
                           : tile == 64  ? pairwise_mma_kernel<64>
                           : tile == 128 ? pairwise_mma_kernel<128> : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + tile - 1) / tile;
  const long long items = tiles * (tiles + 1) / 2;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_dependent(centre_kernel, 1, kCentreThreads, 0, s,
                                     pos, centre, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dependent(kernel, static_cast<unsigned>(items), 2 * tile, 0, s,
                         pos, mass, static_cast<const float*>(centre),
                         partial, n, soft2, static_cast<int>(tiles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = 3 * n;
  const unsigned sum_blocks = static_cast<unsigned>(
      (static_cast<long long>(cols) * kSumParts + 255) / 256);
  err = launch_dependent(sym_sum_kernel, sum_blocks, 256, 0, s,
                         static_cast<const float*>(partial), acc,
                         static_cast<int>(tiles), cols);
  return static_cast<int>(err);
}
