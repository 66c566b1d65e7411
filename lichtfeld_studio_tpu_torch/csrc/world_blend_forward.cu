// Kernel P5: the exact world-space (3DGUT, --gut-exact) tile blend,
// forward, for training and for the forward-only frame alike.
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/world_blend_pallas.py
// (_forward_kernel, entry _forward_call <- world_blend_pallas). What it
// computes, not the TPU mechanics: no DMA ring, no MXU contractions, no
// prefix-product rows, no bf16 colour pairs.
//
// What it computes (unchanged by the redesign for the H100):
//
//   * per pixel and instance it evaluates the stream row against the
//     pixel's world ray direction in the linear form y = C'd, z = Md
//     (world_blend_common.cuh, every step rounded as the plain version's,
//     no FMA contraction) and composites front to back;
//   * a contribution counts while the running T (1 - alpha) stays >= 1e-4
//     (the training done flag, world_blend_pallas.py:394-395); colours are
//     clamped to >= 0 when read. There is no inference early stop: the JAX
//     world blend has none, so the forward frame computes exactly what
//     training computes;
//   * besides the image and alpha it writes T_final and the index within
//     the tile's range of each pixel's last counted contribution (-1 if
//     none), where P6 starts its walk back to front and replays these
//     decisions bit for bit. The forward frame takes the same kernel and
//     drops those two.
//
// What bounds it on the H100, and the design. The bound (chip_smoke.py)
// counts 60 float32 operations to bound an instance over a warp's patch,
// 44 (65 rolling) to evaluate and test each (pixel, instance) pair inside a
// patch the bound keeps (18 products and 12 sums for y and z, 10 for the
// squares, the clamp, the division, the sum and the test), and 18 more
// where the pair counts (exp2, the clamp, the transmittance step and test,
// the weight, 4 colour clamps and multiply-adds). The walk is serial in
// depth inside the thread that owns the pixel (T3: 3-4x faster than scans
// across lanes). What the kernel paid for besides: every walked pair
// evaluated, though half of them lie in patches no instance can reach
// (the ray-space mirror keeps 266M of 529M on the fisheye training
// binning); warps on whole rows, too wide for any bound; a block that
// walks until its last pixel is done; tiles in index order. So, after P6
// (csrc/world_blend_backward.cu):
//
//   * one 256-thread block per tile; each WARP owns a compact patch of it
//     (blend_common.cuh: 16 x 8 pixels of a 32-px tile, 4 in a row a
//     thread, their rays and times loaded and their outputs stored as
//     16-byte vectors; 8 x 4 of a 16-px tile, a pixel a thread);
//   * the block gathers the tile's depth-sorted instances in batches of
//     256, one thread an instance, through gaussian_idx into shared memory
//     (no gathered stream in device memory), and stores each row's norms
//     beside it (world_blend_common.cuh's row_norms);
//   * a (warp, instance) skip in ray space (world_blend_common.cuh's
//     ray_bound, P6's bound): 32 instances at a time, lane j bounds instance
//     j, one ballot; the warp walks only the set bits of walk & ~skip,
//     front to back. A skipped pair has s > log2(255) at every pixel of the
//     patch, which the per-pixel test drops too: the skip changes no bit
//     of the image, T_final or `last`;
//   * the same bound also caps |z|^2 over the patch (world_blend_common.cuh's
//     ray_bound), so each pixel first computes |y|^2 alone and drops the
//     pair where |y|^2 exceeds what any |z| of the patch allows
//     (reject_above, with margins for every rounding): such a pair has
//     s > log2(255), and it skips z, |z|^2, the division and the sum (24
//     of the pair's 44 operations). The pairs that pass take the exact s,
//     in the plain version's order;
//   * a warp whose pixels are all done stops evaluating (a vote a round of
//     32 instances) and still takes part in the block's gathers and
//     barriers; the block stops gathering once every pixel is done;
//   * where the tiles outnumber the blocks the card holds at once, they run
//     heaviest first (blend_common.cuh's ranking, into the caller's
//     scratch of grid_w * grid_h ints);
//   * occupancy: registers capped for three blocks an SM (kBlocksPerSm),
//     28 KB (global shutter) or 36 KB (rolling) of shared memory a block.
//
// The counting instance (lfs_world_blend_forward_stats, a diagnostic) adds
// to stats[3] the (warp, instance) pairs walked, those the ray-space bound
// skipped, and the pixels, not yet done, inside skipped pairs or dropped
// before z whose evaluation passes the keep test (0 unless a bound is not
// conservative).

#include "blend_common.cuh"
#include "world_blend_common.cuh"

namespace {

using namespace lfs_world;
using lfs_blend::kFullMask;
using lfs_blend::Patch;

constexpr int kBatch = kThreads;  // one instance a thread
constexpr int kBlocksPerSm = 3;

template <int kTile, bool kRS, bool kStats>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    world_blend_forward_kernel(const int* __restrict__ tile_order,  // null: tile order
                               const int* __restrict__ tile_start,
                               const int* __restrict__ tile_count,
                               const int* __restrict__ gaussian_idx,
                               const float* __restrict__ stream,  // [N, kRows]
                               const float* __restrict__ rays_d,  // [Hp*Wp, 3]
                               const float* __restrict__ tau,     // [Hp*Wp], kRS only
                               int n_ch, int grid_w,
                               float* __restrict__ image,    // [Hp, Wp, n_ch]
                               float* __restrict__ alpha,    // [Hp, Wp]
                               float* __restrict__ t_final,  // [Hp, Wp]
                               int* __restrict__ last,       // [Hp, Wp]
                               unsigned long long* __restrict__ stats) {  // kStats: [3]
  using L = Layout<kRS>;
  using P = Patch<kTile>;
  constexpr int kQuads = L::kRows / 4;
  constexpr int kPerThread = P::kPerThread;
  __shared__ float4 s_f[kBatch][kQuads];
  __shared__ float4 s_norm[kBatch];  // row_norms of each row

  const int tile = tile_order ? tile_order[blockIdx.x] : blockIdx.x;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const P patch(tile, grid_w, warp, lane);
  const size_t pix0 = (size_t)patch.ty * grid_w * kTile + patch.tx;

  float d[kPerThread][3], tp[kPerThread], T[kPerThread];
  float acc[kPerThread][4];
  int last_k[kPerThread];
  bool done[kPerThread];
  if constexpr (kPerThread == 4) {  // 16-byte loads: pix0 is a multiple of 4
    const float4* r4 = reinterpret_cast<const float4*>(rays_d + 3 * pix0);
    const float4 r0 = r4[0], r1 = r4[1], r2 = r4[2];
    const float r[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
    const float4 u4 = kRS ? *reinterpret_cast<const float4*>(tau + pix0) : make_float4(0, 0, 0, 0);
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) d[i][j] = r[3 * i + j];
      tp[i] = u[i];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) d[0][j] = rays_d[3 * pix0 + j];
    tp[0] = kRS ? tau[pix0] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    T[i] = 1.0f;
    last_k[i] = -1;
    done[i] = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }
  // the patch in ray space (world_blend_common.cuh)
  const RayPatch rp = ray_patch<kPerThread>(d, tp);
  unsigned n_seen = 0, n_skipped = 0, n_lost = 0;  // kStats

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
      float row[L::kRows];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 v = src[q];
        s_f[threadIdx.x][q] = v;
        row[4 * q] = v.x, row[4 * q + 1] = v.y, row[4 * q + 2] = v.z, row[4 * q + 3] = v.w;
      }
      s_norm[threadIdx.x] = row_norms<kRS>(row);
    }
    __syncthreads();

    const int nb = min(kBatch, count - b0);
    bool warp_done = __all_sync(kFullMask, all_mine);  // this warp's pixels are all done
    // 32 instances at a time: lane j bounds instance q + j over the patch,
    // one ballot; the warp walks the ones it cannot skip, front to back
    for (int q = 0; q < nb && !warp_done; q += 32) {
      const bool valid = q + lane < nb;
      bool skip_mine = false;
      float reject = INFINITY;  // lane j's instance: |y|^2 above which no pixel keeps it
      if (valid) {
        const float* f = reinterpret_cast<const float*>(&s_f[q + lane][0]);
        const RayBound rb = ray_bound<kRS>(rp, f, s_norm[q + lane]);
        skip_mine = rb.skip;
        reject = reject_above(f[L::kNlog], rb.den_hi);
      }
      const unsigned walk = __ballot_sync(kFullMask, valid);
      const unsigned skip = __ballot_sync(kFullMask, skip_mine);
      if constexpr (kStats) {
        n_seen += __popc(walk);
        n_skipped += __popc(skip);
        for (unsigned m = skip; m != 0u; m &= m - 1u) {
          const float* f = reinterpret_cast<const float*>(&s_f[q + __ffs(m) - 1][0]);
#pragma unroll
          for (int i = 0; i < kPerThread; ++i)
            if (!done[i] && world_eval<kRS>(f, d[i][0], d[i][1], d[i][2], tp[i]).s <= kLog2MaxS)
              ++n_lost;
        }
      }
      for (unsigned todo = walk & ~skip; todo != 0u; todo &= todo - 1u) {
        const int jj = __ffs(todo) - 1;
        const int j = q + jj;
        const float* f = reinterpret_cast<const float*>(&s_f[j][0]);
        const float num_max = __shfl_sync(kFullMask, reject, jj);
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          if (done[i]) continue;
          const float num = world_num<kRS>(f, d[i][0], d[i][1], d[i][2], tp[i]);
          if (num > num_max) {  // s > log2(255) whatever |z|: no z, no division
            if constexpr (kStats)
              n_lost += world_s<kRS>(f, num, d[i][0], d[i][1], d[i][2]) <= kLog2MaxS ? 1u : 0u;
            continue;
          }
          const float s = world_s<kRS>(f, num, d[i][0], d[i][1], d[i][2]);
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
      bool mine = true;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) mine = mine && done[i];
      warp_done = __all_sync(kFullMask, mine);
    }
  }

  if constexpr (kPerThread == 4) {  // 16-byte stores: pix0 is a multiple of 4
    float4* img = reinterpret_cast<float4*>(image + pix0 * n_ch);
    if (n_ch > 3) {
#pragma unroll
      for (int i = 0; i < 4; ++i) img[i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      img[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[1][0]);
      img[1] = make_float4(acc[1][1], acc[1][2], acc[2][0], acc[2][1]);
      img[2] = make_float4(acc[2][2], acc[3][0], acc[3][1], acc[3][2]);
    }
    *reinterpret_cast<float4*>(alpha + pix0) =
        make_float4(1.0f - T[0], 1.0f - T[1], 1.0f - T[2], 1.0f - T[3]);
    *reinterpret_cast<float4*>(t_final + pix0) = make_float4(T[0], T[1], T[2], T[3]);
    *reinterpret_cast<int4*>(last + pix0) = make_int4(last_k[0], last_k[1], last_k[2], last_k[3]);
  } else {
    for (int c = 0; c < n_ch; ++c) image[pix0 * n_ch + c] = acc[0][c];
    alpha[pix0] = 1.0f - T[0];
    t_final[pix0] = T[0];
    last[pix0] = last_k[0];
  }
  if constexpr (kStats) {
    n_lost = __reduce_add_sync(kFullMask, n_lost);
    if (lane == 0) {  // integer counts: any order, one result
      atomicAdd(&stats[0], static_cast<unsigned long long>(n_seen));
      atomicAdd(&stats[1], static_cast<unsigned long long>(n_skipped));
      atomicAdd(&stats[2], static_cast<unsigned long long>(n_lost));
    }
  }
}

template <int kTile, bool kRS, bool kStats>
int launch(const void* tile_start, const void* tile_count, const void* gaussian_idx,
           const void* stream, const void* rays_d, const void* tau, int n_ch, int grid_w,
           int grid_h, void* image, void* alpha, void* t_final, void* last, void* stats,
           void* order_scratch, cudaStream_t s) {
  const int n_tiles = grid_w * grid_h;
  constexpr auto kernel = world_blend_forward_kernel<kTile, kRS, kStats>;
  const int* order = lfs_blend::heaviest_first<kernel>(
      static_cast<const int*>(tile_count), n_tiles, static_cast<int*>(order_scratch), s);
  kernel<<<n_tiles, kThreads, 0, s>>>(
      order, static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(gaussian_idx), static_cast<const float*>(stream),
      static_cast<const float*>(rays_d), static_cast<const float*>(tau), n_ch, grid_w,
      static_cast<float*>(image), static_cast<float*>(alpha), static_cast<float*>(t_final),
      static_cast<int*>(last), static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}

template <bool kStats>
int launch_any(const void* tile_start, const void* tile_count, const void* gaussian_idx,
               const void* stream, int n_rows, const void* rays_d, const void* tau, int n_ch,
               int grid_w, int grid_h, int tile_size, void* image, void* alpha, void* t_final,
               void* last, void* stats, void* order_scratch, void* cuda_stream) {
  const bool rs = n_rows == 32;
  if ((tile_size != 16 && tile_size != 32) || (n_rows != 24 && n_rows != 32) ||
      n_ch < 3 || n_ch > 4 || t_final == nullptr || last == nullptr || (tau != nullptr) != rs)
    return static_cast<int>(cudaErrorInvalidValue);
  auto fn = tile_size == 16 ? (rs ? launch<16, true, kStats> : launch<16, false, kStats>)
                            : (rs ? launch<32, true, kStats> : launch<32, false, kStats>);
  return fn(tile_start, tile_count, gaussian_idx, stream, rays_d, tau, n_ch, grid_w, grid_h,
            image, alpha, t_final, last, stats, order_scratch,
            static_cast<cudaStream_t>(cuda_stream));
}

}  // namespace

// `order_scratch` is room for grid_w * grid_h ints.
extern "C" int lfs_world_blend_forward(const void* tile_start, const void* tile_count,
                                       const void* gaussian_idx, const void* stream,
                                       int n_rows, const void* rays_d, const void* tau,
                                       int n_ch, int grid_w, int grid_h, int tile_size,
                                       void* image, void* alpha, void* t_final, void* last,
                                       void* order_scratch, void* cuda_stream) {
  return launch_any<false>(tile_start, tile_count, gaussian_idx, stream, n_rows, rays_d, tau,
                           n_ch, grid_w, grid_h, tile_size, image, alpha, t_final, last, nullptr,
                           order_scratch, cuda_stream);
}

// The counting instance: lfs_world_blend_forward's arguments with `stats`
// (unsigned long long [3], added to; see the header) before the scratch.
extern "C" int lfs_world_blend_forward_stats(const void* tile_start, const void* tile_count,
                                             const void* gaussian_idx, const void* stream,
                                             int n_rows, const void* rays_d, const void* tau,
                                             int n_ch, int grid_w, int grid_h, int tile_size,
                                             void* image, void* alpha, void* t_final, void* last,
                                             void* stats, void* order_scratch,
                                             void* cuda_stream) {
  return launch_any<true>(tile_start, tile_count, gaussian_idx, stream, n_rows, rays_d, tau,
                          n_ch, grid_w, grid_h, tile_size, image, alpha, t_final, last, stats,
                          order_scratch, cuda_stream);
}
