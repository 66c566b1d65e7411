// Kernel P6: the exact world-space (3DGUT) tile blend, backward: per-instance
// gradients of every stream row.
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/world_blend_pallas.py
// (_backward_kernel, entry _backward_call <- _world_bwd2). The TPU kernel
// replays each tile front to back in chunks with prefix scans, contracts
// the per-pixel terms into moments on the MXU, packs colour gradients as
// bf16 pairs, writes rows in SORTED order with a boundary head merge, and
// needs a restore sort (sort_rows_to_slot_order) before the reduction. This
// kernel follows P3 (csrc/blend_backward.cu):
//
//   * one 256-thread block per tile, 32x32 (4 pixels per thread) or 16x16
//     (1 pixel per thread); each pixel starts at its last counted
//     contribution (P5's training output) with T = T_final and walks the
//     tile's range BACK to front; T before contribution i is
//     T_(i+1) / (1 - alpha_i), safe because the 0.999 clamp keeps
//     1 - alpha >= 1e-3; the colour behind, S_i = sum_(j>i) w_j (c_j . g),
//     is a running sum;
//   * dL/dalpha_i = T_i (c_i . g) - (S_i + g_T T_final) / (1 - alpha_i),
//     g_T = -dL/d(alpha image); below the 0.999 clamp
//     g_s = dL/ds = -ln2 alpha dL/dalpha (alpha = 2^-s), and with
//     u1 = 2 g_s / |z|^2 and u2 = -u1 |y|^2 / |z|^2
//     (world_blend_pallas.py:543-563):
//       dC'_kj += u1 y_k d_j   (rolling: dC0'_kj += u1 y_k d_j,
//                               dC1'_kj += u1 tau y_k d_j)
//       dM_kj  += u2 z_k d_j
//       d(-log2 op) += g_s     (d/d(-log2 op) only: autograd outside chains
//                               through -log2(op); applying that chain here
//                               too would count it twice, :555-557)
//       d(colour_c) += w g_c, zeroed where the raw colour is <= 0;
//   * shared-memory batches of 32 instances, gathered through gaussian_idx
//     from the per-gaussian stream; the (pixel, instance) evaluation is P5's
//     (world_blend_common.cuh), so the keep tests fall as in the forward;
//   * per instance the 32 sums over the tile's pixels are taken in a FIXED
//     order: each thread sums its own pixels, the warp reduce-scatters the
//     32 values with __shfl_xor_sync (31 shuffles; lane l ends with column
//     l), each lane stores its column, and after the batch the 8 warp
//     partials are added in warp order. Deterministic, no atomics;
//   * each instance's row is written to its PRE-SORT slot,
//     out[slot_layout[i]]: each instance lies in exactly one tile, so writes
//     never collide, and the rows land where P4's segments expect them. No
//     restore sort.
//
// Bound on the H100: per (pixel, walked instance) P5's 44 float32
// operations (65 rolling) to replay and test the pair, most of which fail
// the test; per counted pair 79 more (106 rolling): exp2 and the clamp,
// T_before, the weight, dL/dalpha, the colour terms, u1 and u2, and the 18
// (27 rolling) multiply-adds into the C' and M accumulators; plus per
// instance and warp 31 shuffles. Compute- and latency-bound like P3. The
// gather is 96 or 128 B and the write 96 or 128 B per instance.

#include "world_blend_common.cuh"

namespace {

using namespace lfs_world;

constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;
constexpr int kCols = 32;  // accumulator columns (a stream row, padded to 32)

// Reduce-scatter v[0..31] across the warp, one stage per template level
// (O = 16, 8, 4, 2, 1), so every index is a compile-time constant and v
// stays in registers: afterwards v[0] of lane l holds the warp's sum of
// column l. Fixed order, so deterministic.
template <int O>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[kCols], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) warp_reduce_scatter<O / 2>(v, lane);
}

template <int kTile, bool kRS>
__global__ void __launch_bounds__(kThreads)
    world_blend_backward_kernel(const int* __restrict__ tile_start,
                                const int* __restrict__ tile_count,
                                const int* __restrict__ gaussian_idx,
                                const int* __restrict__ slot_layout,
                                const float* __restrict__ stream,   // [N, kRows]
                                const float* __restrict__ rays_d,   // [Hp*Wp, 3]
                                const float* __restrict__ tau,      // [Hp*Wp], kRS only
                                int n_ch, int grid_w,
                                const float* __restrict__ t_final,  // [Hp, Wp]
                                const int* __restrict__ last,       // [Hp, Wp]
                                const float* __restrict__ d_image,  // [Hp, Wp, n_ch]
                                const float* __restrict__ d_alpha,  // [Hp, Wp]
                                float* __restrict__ out) {          // [cap, kRows]
  using L = Layout<kRS>;
  constexpr int kQuads = L::kRows / 4;
  constexpr int kPerThread = kTile * kTile / kThreads;  // 4 or 1
  constexpr int kDC1 = 9;  // rolling shutter: first dC1' column
  __shared__ float4 s_f[kBatch][kQuads];
  __shared__ int s_slot[kBatch];
  __shared__ float s_part[kWarps][kBatch][kCols];
  __shared__ int s_walk;

  const int tile = blockIdx.x;
  const int x0 = (tile % grid_w) * kTile;
  const int y0 = (tile / grid_w) * kTile;
  const int start = tile_start[tile];
  const int wp = grid_w * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float d[kPerThread][3], tp[kPerThread], T[kPerThread], S[kPerThread];
  float tail[kPerThread], g[kPerThread][4];
  int Lk[kPerThread];
  int my_last = -1;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const size_t pix = (size_t)(y0 + p / kTile) * wp + (x0 + p % kTile);
#pragma unroll
    for (int j = 0; j < 3; ++j) d[i][j] = rays_d[3 * pix + j];
    tp[i] = kRS ? tau[pix] : 0.0f;
    T[i] = t_final[pix];
    S[i] = 0.0f;
    tail[i] = -d_alpha[pix] * T[i];  // g_T * T_final
#pragma unroll
    for (int c = 0; c < 4; ++c) g[i][c] = c < n_ch ? d_image[pix * n_ch + c] : 0.0f;
    Lk[i] = last[pix];
    my_last = max(my_last, Lk[i]);
  }
  if (threadIdx.x == 0) s_walk = -1;
  __syncthreads();
  atomicMax(&s_walk, my_last);  // a max: the same result in any order
  __syncthreads();
  const int walk = min(s_walk + 1, tile_count[tile]);

  for (int b_end = walk; b_end > 0; b_end -= kBatch) {
    const int b0 = max(b_end - kBatch, 0);
    const int nb = b_end - b0;
    __syncthreads();  // the previous batch's rows and partials are read
    if (threadIdx.x < nb * kQuads) {
      const int jj = threadIdx.x / kQuads;
      const int q = threadIdx.x % kQuads;
      const int gi = gaussian_idx[start + b0 + jj];
      s_f[jj][q] = reinterpret_cast<const float4*>(stream + (size_t)gi * L::kRows)[q];
    }
    if (threadIdx.x < nb) s_slot[threadIdx.x] = slot_layout[start + b0 + threadIdx.x];
    __syncthreads();

    for (int jj = nb - 1; jj >= 0; --jj) {
      const int k = b0 + jj;
      const float* f = reinterpret_cast<const float*>(&s_f[jj][0]);
      float col[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) col[c] = fmaxf(f[L::kColor + c], 0.0f);
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
      bool touched = false;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (k > Lk[i]) continue;  // behind this pixel's last counted one
        const WorldEval e = world_eval<kRS>(f, d[i][0], d[i][1], d[i][2], tp[i]);
        if (!(e.s <= kLog2MaxS)) continue;
        const float a_raw = exp2f(-e.s);
        const float a = fminf(a_raw, kMaxAlpha);
        // k <= L and not skipped: counted (the counted set is a prefix)
        touched = true;
        const float one_m = __fsub_rn(1.0f, a);
        const float t_before = T[i] / one_m;
        const float w = t_before * a;
        const float cgv = col[0] * g[i][0] + col[1] * g[i][1] + col[2] * g[i][2] +
                          col[3] * g[i][3];
        const float dalpha = t_before * cgv - (S[i] + tail[i]) / one_m;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[L::kColor + c] += w * g[i][c];
        if (a_raw < kMaxAlpha) {  // below the clamp: alpha depends on s
          const float gs = -kLn2 * a * dalpha;  // dL/ds
          const float inv_den = 1.0f / fmaxf(e.den, 1e-30f);
          const float u1 = 2.0f * gs * inv_den;
          const float u2 = -u1 * (e.num * inv_den);
          const float uy[3] = {u1 * e.y0, u1 * e.y1, u1 * e.y2};
          const float uz[3] = {u2 * e.z0, u2 * e.z1, u2 * e.z2};
#pragma unroll
          for (int r = 0; r < 3; ++r) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              acc[3 * r + j] += uy[r] * d[i][j];
              if constexpr (kRS) acc[kDC1 + 3 * r + j] += uy[r] * tp[i] * d[i][j];
              acc[L::kZ + 3 * r + j] += uz[r] * d[i][j];
            }
          }
          acc[L::kNlog] += gs;
        }
        S[i] += w * cgv;
        T[i] = t_before;
      }
      if (__any_sync(0xffffffffu, touched)) {
        warp_reduce_scatter<kCols / 2>(acc, lane);
      } else {
        acc[0] = 0.0f;
      }
      s_part[warp][jj][lane] = acc[0];
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < nb * L::kRows; idx += kThreads) {
      const int jj = idx / L::kRows;
      const int c = idx % L::kRows;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_part[w][jj][c];
      const float* f = reinterpret_cast<const float*>(&s_f[jj][0]);
      if (c >= L::kColor && c < L::kColor + 4 && f[c] <= 0.0f)
        v = 0.0f;  // the colour clamp max(c, 0) passes no gradient below 0
      out[(size_t)s_slot[jj] * L::kRows + c] = v;
    }
  }
}

}  // namespace

extern "C" int lfs_world_blend_backward(const void* tile_start, const void* tile_count,
                                        const void* gaussian_idx, const void* slot_layout,
                                        const void* stream, int n_rows, const void* rays_d,
                                        const void* tau, int n_ch, int grid_w, int grid_h,
                                        int tile_size, const void* t_final, const void* last,
                                        const void* d_image, const void* d_alpha, void* out,
                                        void* cuda_stream) {
  const bool rs = n_rows == 32;
  if ((tile_size != 16 && tile_size != 32) || (n_rows != 24 && n_rows != 32) || n_ch < 3 ||
      n_ch > 4 || (tau != nullptr) != rs)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tile_size == 16 ? (rs ? world_blend_backward_kernel<16, true>
                                      : world_blend_backward_kernel<16, false>)
                                : (rs ? world_blend_backward_kernel<32, true>
                                      : world_blend_backward_kernel<32, false>);
  kernel<<<grid_w * grid_h, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(gaussian_idx), static_cast<const int*>(slot_layout),
      static_cast<const float*>(stream), static_cast<const float*>(rays_d),
      static_cast<const float*>(tau), n_ch, grid_w, static_cast<const float*>(t_final),
      static_cast<const int*>(last), static_cast<const float*>(d_image),
      static_cast<const float*>(d_alpha), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
