// Kernel P5: the exact world-space (3DGUT, --gut-exact) tile blend,
// forward, for training and for the forward-only frame alike.
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/world_blend_pallas.py
// (_forward_kernel, entry _forward_call <- world_blend_pallas). What it
// computes, not the TPU mechanics: no DMA ring, no MXU contractions, no
// prefix-product rows, no bf16 colour pairs. Per pixel and instance it
// evaluates the stream row against the pixel's world ray direction (see
// world_blend_common.cuh) and composites front to back:
//
//   * one 256-thread block per tile, 32x32 (4 pixels per thread) or 16x16
//     (1 pixel per thread), the layout of P2 (csrc/blend_forward.cu);
//   * the block walks the tile's depth-sorted instance range in batches of
//     256: each thread reads one gaussian_idx and copies that gaussian's
//     stream row (24 or 32 floats, as float4s) into shared memory, so no
//     gathered instance stream exists in device memory (the JAX package
//     materialised one, _gather_stream);
//   * each pixel reads its direction (and, rolling shutter, its shutter
//     time tau) from the ray table once;
//   * a contribution counts while the running T (1 - alpha) stays >= 1e-4
//     (the training done flag, world_blend_pallas.py:394-395); colours are
//     clamped to >= 0 when read. There is no inference early stop: the JAX
//     world blend has none, so the forward frame computes exactly what
//     training computes;
//   * once every pixel of the block is done the block stops walking;
//   * besides the image and alpha it writes T_final and the index within
//     the tile's range of each pixel's last counted contribution (-1 if
//     none), where P6 starts its walk back to front. The forward frame
//     takes the same kernel and drops those two.
//
// Bound on the H100: per (pixel, walked instance) 44 float32 operations
// to evaluate and test the pair (18 products and 12 sums for y and z, 10
// for the squares, the clamp, the division, the sum and the test; 65 with
// a rolling shutter), and 18 more where the pair counts (exp2, the clamp,
// the transmittance step and test, the weight, 4 colour clamps and
// multiply-adds), on a walk that is serial in depth; the per-instance
// gather is 96 or 128 B per walked instance and tile, from L2 mostly.
// Compute- and latency-bound in the inner loop, as P2; the shared-memory
// batch serves 1024 pixels from one gather.

#include "world_blend_common.cuh"

namespace {

using namespace lfs_world;

constexpr int kBatch = kThreads;

template <int kTile, bool kRS>
__global__ void __launch_bounds__(kThreads)
    world_blend_forward_kernel(const int* __restrict__ tile_start,
                               const int* __restrict__ tile_count,
                               const int* __restrict__ gaussian_idx,
                               const float* __restrict__ stream,  // [N, kRows]
                               const float* __restrict__ rays_d,  // [Hp*Wp, 3]
                               const float* __restrict__ tau,     // [Hp*Wp], kRS only
                               int n_ch, int grid_w,
                               float* __restrict__ image,    // [Hp, Wp, n_ch]
                               float* __restrict__ alpha,    // [Hp, Wp]
                               float* __restrict__ t_final,  // [Hp, Wp]
                               int* __restrict__ last) {     // [Hp, Wp]
  using L = Layout<kRS>;
  constexpr int kQuads = L::kRows / 4;
  constexpr int kPerThread = kTile * kTile / kThreads;  // 4 or 1
  __shared__ float4 s_f[kBatch][kQuads];

  const int tile = blockIdx.x;
  const int x0 = (tile % grid_w) * kTile;
  const int y0 = (tile / grid_w) * kTile;
  const int wp = grid_w * kTile;
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  float d[kPerThread][3], tp[kPerThread], T[kPerThread];
  float acc[kPerThread][4];
  int last_k[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const size_t pix = (size_t)(y0 + p / kTile) * wp + (x0 + p % kTile);
#pragma unroll
    for (int j = 0; j < 3; ++j) d[i][j] = rays_d[3 * pix + j];
    tp[i] = kRS ? tau[pix] : 0.0f;
    T[i] = 1.0f;
    last_k[i] = -1;
    done[i] = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    bool all_mine = true;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) all_mine = all_mine && done[i];
    // also the barrier that keeps the previous batch alive until read
    if (__syncthreads_count(all_mine) == kThreads) break;

    const int k = b0 + threadIdx.x;
    if (k < count) {
      const int g = gaussian_idx[start + k];
      const float4* src = reinterpret_cast<const float4*>(stream + (size_t)g * L::kRows);
#pragma unroll
      for (int q = 0; q < kQuads; ++q) s_f[threadIdx.x][q] = src[q];
    }
    __syncthreads();

    const int nb = min(kBatch, count - b0);
    for (int j = 0; j < nb; ++j) {
      const float* f = reinterpret_cast<const float*>(&s_f[j][0]);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (done[i]) continue;
        const float s = world_eval<kRS>(f, d[i][0], d[i][1], d[i][2], tp[i]).s;
        if (!(s <= kLog2MaxS)) continue;  // alpha_raw < 1/255 (or NaN)
        const float a = fminf(exp2f(-s), kMaxAlpha);
        const float next_t = __fmul_rn(T[i], __fsub_rn(1.0f, a));
        if (next_t < kDoneThreshold) {  // reference done flag
          done[i] = true;
          continue;
        }
        const float w = __fmul_rn(T[i], a);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += w * fmaxf(f[L::kColor + c], 0.0f);
        T[i] = next_t;
        last_k[i] = b0 + j;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const size_t pix = (size_t)(y0 + p / kTile) * wp + (x0 + p % kTile);
    for (int c = 0; c < n_ch; ++c) image[pix * n_ch + c] = acc[i][c];
    alpha[pix] = 1.0f - T[i];
    t_final[pix] = T[i];
    last[pix] = last_k[i];
  }
}

}  // namespace

extern "C" int lfs_world_blend_forward(const void* tile_start, const void* tile_count,
                                       const void* gaussian_idx, const void* stream,
                                       int n_rows, const void* rays_d, const void* tau,
                                       int n_ch, int grid_w, int grid_h, int tile_size,
                                       void* image, void* alpha, void* t_final, void* last,
                                       void* cuda_stream) {
  const bool rs = n_rows == 32;
  if ((tile_size != 16 && tile_size != 32) || (n_rows != 24 && n_rows != 32) ||
      n_ch < 3 || n_ch > 4 || t_final == nullptr || last == nullptr || (tau != nullptr) != rs)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tile_size == 16 ? (rs ? world_blend_forward_kernel<16, true>
                                      : world_blend_forward_kernel<16, false>)
                                : (rs ? world_blend_forward_kernel<32, true>
                                      : world_blend_forward_kernel<32, false>);
  kernel<<<grid_w * grid_h, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(gaussian_idx), static_cast<const float*>(stream),
      static_cast<const float*>(rays_d), static_cast<const float*>(tau), n_ch, grid_w,
      static_cast<float*>(image), static_cast<float*>(alpha), static_cast<float*>(t_final),
      static_cast<int*>(last));
  return static_cast<int>(cudaGetLastError());
}
