// Direct O(N^2) softened-gravity accelerations for Hopper (sm_90a): three
// kernels for the three regimes of the simulator.
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
// The TPU layout is not carried over: no (8, N_pad) packing, no transposed
// copy, no padding of N. Positions are read as (N, 3) rows, G*m is formed
// while a tile is staged, a ragged last tile is filled with zero-mass
// sources at the origin (they exert exactly zero force) and rows beyond N
// are never written.
//
// A coincident pair (d^2 == 0, the self pair included) contributes exactly
// zero in all three kernels: the factor is selected away, not multiplied by a
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

}  // namespace

// Plain C entry points, called through ctypes. pos (b, n, 3), mass (b, n),
// acc (b, n, 3) float32, contiguous, on one device; soft2 = eps^2. The
// symmetric form takes one system (n, 3) and a (ceil(n / 128), n, 3) float32
// scratch. They launch on `stream` and return cudaGetLastError() (0 on
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
