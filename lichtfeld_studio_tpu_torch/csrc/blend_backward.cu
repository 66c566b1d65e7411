// Kernel P3: blend backward, per-instance gradients of the training blend.
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/blend_pallas.py
// (_backward_kernel, entry _backward_call <- _blend_gathered_bwd), compact
// layout. The TPU kernel replays each tile FRONT to back in 128-instance
// chunks, carries the colour-behind sum as a prefix scan, contracts the
// geometry gradients as six pixel moments on the MXU, writes per-instance
// rows in SORTED order with a read-merge-write at unaligned chunk
// boundaries, and needs a restore sort (sort_rows_to_slot_order) before the
// reduction. This kernel is the upstream CUDA shape (fastgs
// blend_backward_cu, kernels_backward.cuh):
//
//   * one 256-thread block per tile, 32x32 (4 pixels per thread) or 16x16
//     (1 pixel per thread), the forward's pixel layout;
//   * each pixel starts at its last counted contribution (the index the
//     training forward wrote) with T = T_final and walks the tile's range
//     BACK to front; the block starts at the largest such index. Before
//     contribution i: T_i = T_(i+1) / (1 - alpha_i), exact up to rounding
//     since alpha <= 0.999 keeps 1 - alpha >= 1e-3; the colour behind,
//     S_i = sum_(j>i) w_j (c_j . g), is a running sum;
//   * dL/dalpha_i = T_i (c_i . g) - (S_i + g_T T_final) / (1 - alpha_i),
//     with g_T = -dL/d(alpha image) the T_final cotangent
//     (blend_pallas.py:619-623); u = dL/dsigma = -alpha dL/dalpha where
//     alpha is below the 0.999 clamp (0 where clamped);
//     d_mean = sum_p u (a dx + b dy, c dy + b dx), d_conic = sum_p u
//     (dx^2/2, dx dy, dy^2/2), d_opacity = -sum_p u / op,
//     d_colour = sum_p w g, zeroed where the raw colour is <= 0
//     (blend_pallas.py:673-757);
//   * shared-memory batches of 64 instances are gathered from gaussian_idx
//     as in P2 (the same sigma/alpha operation order, so the skip tests
//     fall as in the forward);
//   * the per-instance sum over the tile's pixels is taken in a FIXED
//     order: each thread sums its own pixels, __shfl_xor_sync reduces the
//     warp, lane 0 stores the warp's partial in shared memory, and after
//     the batch the 8 warp partials are added in warp order. The result is
//     deterministic (no atomics);
//   * each instance's row of F = 6 + n_ch floats is written to its PRE-SORT
//     slot, out[slot_layout[i]]: each instance lies in exactly one tile and
//     slot_layout is a permutation of the valid slots, so writes never
//     collide, and the rows land in slot order, where each gaussian's
//     instances are one contiguous segment for P4. No restore sort.
//
// Not ported: the TPU kernel's tail trim at GRAD_SKIP_EPS = 1/255 (it stops
// the replay at the last chunk whose weight bound is >= 1/255, an
// approximation chosen for TPU speed). This kernel replays every counted
// contribution: the exact gradient, which the JAX package gives with
// GRAD_SKIP_EPS = 0. A trim is later performance work.
//
// Bound on the H100: per (pixel, walked instance) 16 float32 operations
// to replay and test the pair (P2's), most of which fail the test; per
// counted pair 51 more (two divisions among them: T_before, the weight,
// dL/dalpha, the colour and geometry terms); plus per instance and warp a
// 10-value shuffle reduction (skipped when no lane of the warp touches the
// instance). Like
// P2 it is compute- and latency-bound in the inner loop; the gather is
// 40 B and the write 4 F bytes per instance.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 64;
constexpr int kMaxF = 10;  // 6 geometry + up to 4 channels
constexpr float kMaxAlpha = 0.999f;
constexpr float kMinAlpha = 1.0f / 255.0f;

template <int kTile>
__global__ void __launch_bounds__(kThreads)
    blend_backward_kernel(const int* __restrict__ tile_start,
                          const int* __restrict__ tile_count,
                          const int* __restrict__ gaussian_idx,
                          const int* __restrict__ slot_layout,
                          const float* __restrict__ mean2d,   // [N, 2]
                          const float* __restrict__ conic,    // [N, 3]
                          const float* __restrict__ opacity,  // [N]
                          const float* __restrict__ color,    // [N, n_ch]
                          int n_ch, int grid_w,
                          const float* __restrict__ t_final,  // [Hp, Wp]
                          const int* __restrict__ last,       // [Hp, Wp]
                          const float* __restrict__ d_image,  // [Hp, Wp, n_ch]
                          const float* __restrict__ d_alpha,  // [Hp, Wp]
                          float* __restrict__ out) {          // [cap, 6 + n_ch]
  constexpr int kPerThread = kTile * kTile / kThreads;  // 4 or 1
  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_conop[kBatch];
  __shared__ float4 s_col[kBatch];  // raw colours (unclamped)
  __shared__ int s_slot[kBatch];
  __shared__ float s_part[kWarps][kBatch][kMaxF];
  __shared__ int s_walk;

  const int tile = blockIdx.x;
  const int x0 = (tile % grid_w) * kTile;
  const int y0 = (tile / grid_w) * kTile;
  const int start = tile_start[tile];
  const int wp = grid_w * kTile;
  const int n_f = 6 + n_ch;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[kPerThread], py[kPerThread], T[kPerThread], S[kPerThread];
  float tail[kPerThread], g[kPerThread][4];
  int L[kPerThread];
  int my_last = -1;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const size_t pix = (size_t)(y0 + p / kTile) * wp + (x0 + p % kTile);
    px[i] = static_cast<float>(x0 + p % kTile) + 0.5f;
    py[i] = static_cast<float>(y0 + p / kTile) + 0.5f;
    T[i] = t_final[pix];
    S[i] = 0.0f;
    tail[i] = -d_alpha[pix] * T[i];  // g_T * T_final
    const float* gp = d_image + pix * n_ch;
    g[i][0] = gp[0];
    g[i][1] = gp[1];
    g[i][2] = gp[2];
    g[i][3] = n_ch > 3 ? gp[3] : 0.0f;
    L[i] = last[pix];
    my_last = max(my_last, L[i]);
  }
  if (threadIdx.x == 0) s_walk = -1;
  __syncthreads();
  atomicMax(&s_walk, my_last);  // a max: the same result in any order
  __syncthreads();
  const int walk = min(s_walk + 1, tile_count[tile]);

  for (int b_end = walk; b_end > 0; b_end -= kBatch) {
    const int b0 = max(b_end - kBatch, 0);
    const int nb = b_end - b0;
    __syncthreads();  // the previous batch's features and partials are read
    if (threadIdx.x < nb) {
      const int pos = start + b0 + threadIdx.x;
      const int gi = gaussian_idx[pos];
      s_xy[threadIdx.x] = make_float2(mean2d[2 * gi], mean2d[2 * gi + 1]);
      s_conop[threadIdx.x] = make_float4(conic[3 * gi], conic[3 * gi + 1],
                                         conic[3 * gi + 2], opacity[gi]);
      const float* cg = color + (size_t)gi * n_ch;
      s_col[threadIdx.x] = make_float4(cg[0], cg[1], cg[2], n_ch > 3 ? cg[3] : 0.0f);
      s_slot[threadIdx.x] = slot_layout[pos];
    }
    __syncthreads();

    for (int jj = nb - 1; jj >= 0; --jj) {
      const int k = b0 + jj;
      const float2 xy = s_xy[jj];
      const float4 co = s_conop[jj];
      const float4 raw = s_col[jj];
      const float4 col = make_float4(fmaxf(raw.x, 0.0f), fmaxf(raw.y, 0.0f),
                                     fmaxf(raw.z, 0.0f), fmaxf(raw.w, 0.0f));
      float acc[kMaxF];
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) acc[f] = 0.0f;
      bool touched = false;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (k > L[i]) continue;  // behind this pixel's last counted one
        const float dx = __fsub_rn(xy.x, px[i]);
        const float dy = __fsub_rn(xy.y, py[i]);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                     __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float sigma =
            __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(co.y, dx), dy));
        if (sigma < 0.0f) continue;
        const float a_raw = __fmul_rn(co.w, expf(-sigma));
        const float a = fminf(a_raw, kMaxAlpha);
        if (a < kMinAlpha) continue;
        // k <= L and not skipped: counted (the counted set is a prefix)
        touched = true;
        const float one_m = __fsub_rn(1.0f, a);
        const float t_before = T[i] / one_m;
        const float w = t_before * a;
        const float cgv = col.x * g[i][0] + col.y * g[i][1] + col.z * g[i][2] +
                          col.w * g[i][3];
        const float dalpha = t_before * cgv - (S[i] + tail[i]) / one_m;
        acc[6] += w * g[i][0];
        acc[7] += w * g[i][1];
        acc[8] += w * g[i][2];
        acc[9] += w * g[i][3];
        if (a_raw < kMaxAlpha) {  // below the clamp: alpha depends on sigma, op
          const float u = -a * dalpha;  // dL/dsigma
          acc[0] += u * (co.x * dx + co.y * dy);
          acc[1] += u * (co.z * dy + co.y * dx);
          acc[2] += 0.5f * u * dx * dx;
          acc[3] += u * dx * dy;
          acc[4] += 0.5f * u * dy * dy;
          acc[5] += -u / co.w;
        }
        S[i] += w * cgv;
        T[i] = t_before;
      }
      if (__any_sync(0xffffffffu, touched)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int f = 0; f < kMaxF; ++f)
            acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kMaxF; ++f) s_part[warp][jj][f] = acc[f];
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < nb * n_f; idx += kThreads) {
      const int jj = idx / n_f;
      const int f = idx % n_f;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_part[w][jj][f];
      if (f >= 6 && reinterpret_cast<const float*>(&s_col[jj])[f - 6] <= 0.0f)
        v = 0.0f;  // the colour clamp max(c, 0) passes no gradient below 0
      out[(size_t)s_slot[jj] * n_f + f] = v;
    }
  }
}

}  // namespace

extern "C" int lfs_blend_backward(const void* tile_start, const void* tile_count,
                                  const void* gaussian_idx, const void* slot_layout,
                                  const void* mean2d, const void* conic,
                                  const void* opacity, const void* color, int n_ch,
                                  int grid_w, int grid_h, int tile_size,
                                  const void* t_final, const void* last,
                                  const void* d_image, const void* d_alpha, void* out,
                                  void* stream) {
  if (tile_size != 16 && tile_size != 32) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = grid_w * grid_h;
  auto kernel = tile_size == 16 ? blend_backward_kernel<16> : blend_backward_kernel<32>;
  kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(gaussian_idx), static_cast<const int*>(slot_layout),
      static_cast<const float*>(mean2d), static_cast<const float*>(conic),
      static_cast<const float*>(opacity), static_cast<const float*>(color), n_ch, grid_w,
      static_cast<const float*>(t_final), static_cast<const int*>(last),
      static_cast<const float*>(d_image), static_cast<const float*>(d_alpha),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
