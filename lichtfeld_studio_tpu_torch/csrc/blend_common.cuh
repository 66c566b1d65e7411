// What the tile blends share: the 2D reach of an instance and the warp's
// patch (P2 csrc/blend_forward.cu, P3 csrc/blend_backward.cu), the warp
// reduce-scatter (P3, P6 csrc/world_blend_backward.cu) and the tile ranking
// (P2, P3, P6).
//
// The patch. A block of 256 threads owns one tile; each WARP owns a compact
// patch of it, 16 x 8 pixels of a 32-px tile (4 pixels in a row a thread,
// so a thread's pixels share their y and load as 16-byte vectors) or 8 x 4
// of a 16-px tile (a pixel a thread). A gaussian a few pixels wide reaches
// two to four of the eight patches, not all of them.
//
// The reach. alpha = min(0.999, op exp(-sigma)) counts only where
// alpha >= 1/255, that is 0 <= sigma <= log(255 op): an ellipse around the
// mean. The sigma limit carries a margin of 1e-3 (expf, logf and the
// product round within 1e-6), the ellipse's bounding box one of 0.1% and
// 1e-3 px (the rounding of sigma's terms); a conic with a*c - b*b below
// 1e-3 a*c, or any non-finite input, gets an unbounded box. So a pair
// outside the box, or above the limit, never counts: skipping it changes
// nothing.
//
// The ranking. Tile counts are very uneven and a frame is a few waves of
// blocks, so the last wave waits for its heaviest tile. Where the tiles
// outnumber the blocks the card holds at once, a small kernel first ranks
// them by descending count (one thread a tile counts the tiles ahead of
// it, ties by index: no sort, no host sync) and block i takes the tile of
// rank i. What a tile computes does not depend on when it runs.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>

namespace lfs_blend {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// Margins of the reach: on sigma (expf, logf and the product round within
// 1e-6), on the ellipse's half-extent (relative, for the rounding of
// sigma's terms, and absolute in pixels), and the conditioning below which
// a*c - b*b has too few good bits to bound anything.
constexpr float kSigmaMargin = 1e-3f;
constexpr float kReachRel = 1.001f;
constexpr float kReachAbs = 1e-3f;
constexpr float kMinCondition = 1e-3f;
// The backward's tail trim (P2 records it, P3 applies it): windows of 128
// instances of the sorted order, and the n_eff of a tile kept whole.
constexpr int kTrimShift = 7;
constexpr int kFullReplay = 1 << 30;

// The reach: alpha >= 1/255 needs 0 <= sigma <= log(255 op), an ellipse
// around the mean with half-extents sqrt(2 smax c / det), sqrt(2 smax a /
// det). `box` holds the pixel centres the instance can reach: x, x, y, y.
__device__ __forceinline__ void reach_2d(float mx, float my, float a, float b, float c, float op,
                                         float& smax_out, float4& box_out) {
  const float inf = INFINITY;
  float smax = inf;
  float4 box = make_float4(-inf, inf, -inf, inf);
  if (isfinite(mx + my + a + b + c + op)) {
    smax = op > 0.0f ? logf(op * 255.0f) + kSigmaMargin : -1.0f;
    const float det = a * c - b * b;
    if (!(smax >= 0.0f)) {
      box = make_float4(inf, -inf, inf, -inf);  // counts nowhere
    } else if (a > 0.0f && c > 0.0f && det > kMinCondition * a * c) {
      const float rx = sqrtf(2.0f * smax * c / det) * kReachRel + kReachAbs;
      const float ry = sqrtf(2.0f * smax * a / det) * kReachRel + kReachAbs;
      box = make_float4(mx - rx, mx + rx, my - ry, my + ry);
    }
  }
  smax_out = smax;
  box_out = box;
}

// A warp's patch of a tile and this thread's pixels in it.
template <int kTile>
struct Patch {
  static constexpr int kPerThread = kTile * kTile / kThreads;  // 4 or 1 pixels, one row
  static constexpr int kPatchW = kTile / 2;                    // a warp's patch:
  static constexpr int kPatchH = kTile / 4;                    // 16 x 8 or 8 x 4 pixels
  static constexpr int kAcross = kPatchW / kPerThread;         // threads across a patch
  int wx, wy;  // the patch's first pixel
  int tx, ty;  // this thread's first pixel
  float cx_lo, cx_hi, cy_lo, cy_hi;  // the patch's first and last pixel centres

  __device__ __forceinline__ Patch(int tile, int grid_w, int warp, int lane) {
    wx = (tile % grid_w) * kTile + (warp & 1) * kPatchW;
    wy = (tile / grid_w) * kTile + (warp >> 1) * kPatchH;
    tx = wx + (lane % kAcross) * kPerThread;
    ty = wy + lane / kAcross;
    cx_lo = static_cast<float>(wx) + 0.5f;
    cx_hi = static_cast<float>(wx + kPatchW) - 0.5f;
    cy_lo = static_cast<float>(wy) + 0.5f;
    cy_hi = static_cast<float>(wy + kPatchH) - 0.5f;
  }

  // true when the reach box holds none of the patch's pixel centres
  __device__ __forceinline__ bool misses(const float4& box) const {
    return box.x > cx_hi || box.y < cx_lo || box.z > cy_hi || box.w < cy_lo;
  }
};

// Reduce-scatter the N live values of v across the warp: one stage per
// template level (lane distances 16, 8, 4, 2, 1; N halving, rounded up, at
// each), every index a compile-time constant, so v stays in registers.
// Afterwards v[0] of the lane whose column_of_lane is c holds the warp's
// sum of column c. Fixed order, so deterministic. N = 10 takes 12 shuffles,
// 32 takes 31 (a butterfly of every value: 5 N).
template <int N, int O, int M>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[M], int lane) {
  constexpr int kHalf = (N + 1) / 2;
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float hi = i + kHalf < N ? v[i + kHalf] : 0.0f;
    const float send = upper ? v[i] : hi;
    const float keep = upper ? hi : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, O);
  }
  if constexpr (O > 1) warp_reduce_scatter<kHalf, O / 2>(v, lane);
}

// The column whose sum warp_reduce_scatter<10, 16> leaves in this lane
// (P3's ten sums), or -1 for a lane that ends with padding. (Of 32 columns,
// lane c ends with column c.)
__device__ __forceinline__ int column_of_lane(int lane) {
  if (lane & 1) return -1;
  const int p2 = ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);  // among 3
  const int p1 = ((lane >> 3) & 1) * 3 + p2;                 // among 5
  if (p2 >= 3 || p1 >= 5) return -1;
  return ((lane >> 4) & 1) * 5 + p1;
}

// The kernel and the function below are this translation unit's own.
namespace {

// order[rank] = tile, by descending tile_count, ties by tile index.
__global__ void __launch_bounds__(kThreads)
    tile_order_kernel(const int* __restrict__ tile_count, int n_tiles, int* __restrict__ order) {
  __shared__ int s_count[kThreads];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int mine = t < n_tiles ? tile_count[t] : 0;
  int rank = 0;  // the tiles ahead of this one
  for (int base = 0; base < n_tiles; base += kThreads) {
    __syncthreads();
    if (base + threadIdx.x < n_tiles) s_count[threadIdx.x] = tile_count[base + threadIdx.x];
    __syncthreads();
    const int m = min(kThreads, n_tiles - base);
    for (int j = 0; j < m; ++j) {
      const int c = s_count[j];
      rank += (c > mine || (c == mine && base + j < t)) ? 1 : 0;
    }
  }
  if (t < n_tiles) order[rank] = t;
}

// Ranks the tiles into `order` (room for n_tiles ints) and returns it where
// they outnumber the blocks of kKernel the card holds at once; else null
// (tile order). How many blocks the card holds is asked once a kernel and
// device: after that a launch costs the host one cudaGetDevice and, where
// it ranks, the ranking kernel's launch.
template <auto kKernel>
inline const int* heaviest_first(const int* tile_count, int n_tiles, int* order,
                                 cudaStream_t s) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> s_resident[kMaxDevices];  // 0: not asked yet
  int device = 0, resident = 0;
  cudaGetDevice(&device);
  if (device < kMaxDevices) resident = s_resident[device].load(std::memory_order_relaxed);
  if (resident == 0) {
    int n_sm = 0, per_sm = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads, 0);
    resident = n_sm * per_sm;
    if (device < kMaxDevices) s_resident[device].store(resident, std::memory_order_relaxed);
  }
  if (order == nullptr || n_tiles <= resident) return nullptr;
  tile_order_kernel<<<(n_tiles + kThreads - 1) / kThreads, kThreads, 0, s>>>(tile_count, n_tiles,
                                                                              order);
  return order;
}

}  // namespace
}  // namespace lfs_blend
