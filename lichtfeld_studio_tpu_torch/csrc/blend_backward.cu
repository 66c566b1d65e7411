// Kernel P3: blend backward, per-instance gradients of the training blend.
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/blend_pallas.py
// (_backward_kernel, entry _backward_call <- _blend_gathered_bwd), compact
// layout. The TPU kernel replays each tile FRONT to back in 128-instance
// chunks, carries the colour-behind sum as a prefix scan, contracts the
// geometry gradients as six pixel moments on the MXU, writes per-instance
// rows in SORTED order with a read-merge-write at unaligned chunk
// boundaries, and needs a restore sort (sort_rows_to_slot_order) before the
// reduction.
//
// What it computes (unchanged by the redesign for the H100):
//
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
//   * sigma and alpha in P2's operation order (_rn intrinsics), so the skip
//     tests fall as in the forward;
//   * each instance's row of F = 6 + n_ch floats goes to its PRE-SORT slot,
//     out[slot_layout[i]]: each instance lies in exactly one tile and
//     slot_layout is a permutation of the valid slots, so writes never
//     collide, and the rows land in slot order, where each gaussian's
//     instances are one contiguous segment for P4. No restore sort. Rows of
//     instances that no pixel counts are not written (the caller zeroes).
//
//   * the tail trim (the TPU kernel's GRAD_SKIP_EPS, blend_pallas.py:74-86,
//     :562-567): the training forward (P2) gives each tile n_eff, and every
//     instance at sorted position >= base + 128 n_eff (base = the tile's
//     start rounded down to a multiple of 128) gets a zero row; every other
//     row is exact, because the colour behind S_i still sums the whole
//     frame. n_eff = 1 << 30 (eps 0) replays every counted contribution.
//     The walk still starts at `last`: a pair in the trimmed tail replays
//     alpha, T_i and S_i (which the rows in front need) in a loop of its
//     own, with no moments, reduce-scatter, mask bit or store; the rows in
//     front take the loop as it was.
//     (Starting the walk at the trim instead would need T and S there,
//     which P2 cannot know before its tile's end: S would come from the
//     final colour as a difference, as on the TPU, and lose precision.)
//
// What bounds it on the H100, and the design. The bound (chip_smoke.py)
// counts only the blend arithmetic the data needs (4 float32 operations to
// test an instance against a warp's patch, 10 to replay and test each pair
// inside a patch the reach keeps, 57 more for a pair that counts). What
// the kernel really pays for is instruction slots and latency around it: the sum
// of 6 + n_ch values over the tile's pixels for every instance crosses
// lanes (shuffles run at a quarter of the float32 rate), a warp runs the
// counted path when any of its lanes counts, and each instance is a chain
// of dependent steps. So the design keeps warps away from instances that
// cannot reach them, makes the counted path and the reduction short, and
// keeps three blocks on an SM:
//
//   * one 256-thread block per tile; each WARP owns a compact patch of it
//     (16 x 8 pixels of a 32-px tile, 4 pixels in a row per thread, loaded
//     as 16-byte vectors; 8 x 4 of a 16-px tile), so a gaussian a few pixels
//     wide reaches two to four of the eight warps, not all of them;
//   * when a batch of 96 instances is gathered into shared memory, each
//     instance's reach is stored with it: the sigma above which
//     opacity * exp(-sigma) < 1/255 and the bounding box of that ellipse,
//     both with a margin so that every pair P2 counted is still evaluated
//     (an ill-conditioned or non-finite conic gets an unbounded box). A warp
//     whose patch the box misses, or whose pixels all ended before the
//     instance, skips it with one compare: no exp, no shuffle, no store. A
//     pair above the sigma limit skips before expf;
//   * a counted pair costs one reciprocal (1 / (1 - alpha), shared by T_i
//     and dL/dalpha) and adds to three moments of u (sum u, sum u dx,
//     sum u dx^2) and the colour sums; a thread's pixels share a row, so
//     after its pixels the five geometry gradients and d_opacity follow
//     from the three moments, dy and 1 / opacity (the TPU kernel's pixel
//     moments, per thread);
//   * a warp that counted reduce-scatters its 10 sums in 12 shuffles
//     (5 + 3 + 2 + 1 + 1 across lane distances 16, 8, 4, 2, 1; a butterfly
//     takes 50) in a fixed order, the lanes that end up with a column store
//     it, and the warp sets its bit in the instance's mask;
//   * after the batch the block adds, for each instance, the partials of
//     the warps in its mask in warp order: deterministic, no float atomics;
//   * registers are capped for three blocks an SM (kBlocksPerSm), which
//     hides more of each warp's latency than the last few registers buy.
//
//   * tile counts are very uneven and a frame is a few waves of blocks, so
//     the last wave waits for its heaviest tile. Where the tiles outnumber
//     the blocks the card holds at once, a small kernel first ranks them by
//     descending count (one thread a tile counts the tiles ahead of it, ties
//     by index: no sort, no host sync) and block i takes the tile of rank i.
//     What a tile computes does not depend on when it runs.
//
// The patch, the reach, the reduce-scatter and the ranking live in
// blend_common.cuh, which the forward (P2) shares: both skip by one bound.

#include "blend_common.cuh"

namespace {

// using-declarations, not a using-directive: the header's own anonymous
// namespace must stay out of this file's unqualified lookup
using lfs_blend::column_of_lane;
using lfs_blend::kFullMask;
using lfs_blend::kThreads;
using lfs_blend::kTrimShift;
using lfs_blend::kWarps;
using lfs_blend::Patch;
using lfs_blend::reach_2d;
using lfs_blend::heaviest_first;
using lfs_blend::warp_reduce_scatter;

constexpr int kBatch = 96;
constexpr int kBlocksPerSm = 3;
constexpr int kMaxF = 10;  // 6 geometry + up to 4 channels
constexpr float kMaxAlpha = 0.999f;
constexpr float kMinAlpha = 1.0f / 255.0f;

template <int kTile, bool kStats>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    blend_backward_kernel(const int* __restrict__ tile_order,  // null: tile order
                          const int* __restrict__ tile_start,
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
                          const int* __restrict__ tile_neff,  // [tiles]: the trim
                          const float* __restrict__ d_image,  // [Hp, Wp, n_ch]
                          const float* __restrict__ d_alpha,  // [Hp, Wp]
                          float* __restrict__ out,            // [cap, 6 + n_ch]
                          unsigned long long* __restrict__ stats) {  // kStats: [4]
  using P = Patch<kTile>;
  constexpr int kPerThread = P::kPerThread;
  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_conop[kBatch];
  __shared__ float4 s_col[kBatch];  // raw colours (unclamped)
  __shared__ float4 s_box[kBatch];  // pixel centres the instance can reach: x, x, y, y
  __shared__ float2 s_lim[kBatch];  // sigma above which alpha < 1/255; 1 / opacity
  __shared__ int s_slot[kBatch];
  __shared__ unsigned s_mask[kBatch];  // warps that hold a partial
  __shared__ float s_part[kWarps][kBatch][kMaxF];
  __shared__ int s_walk;

  const int tile = tile_order ? tile_order[blockIdx.x] : blockIdx.x;
  const int start = tile_start[tile];
  const int wp = grid_w * kTile;
  const int n_f = 6 + n_ch;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col_out = column_of_lane(lane);
  const P patch(tile, grid_w, warp, lane);  // the warp's patch and this thread's pixels in it
  const size_t pix0 = (size_t)patch.ty * wp + patch.tx;
  const float py = static_cast<float>(patch.ty) + 0.5f;

  float px[kPerThread], T[kPerThread], S[kPerThread];
  float tail[kPerThread], g[kPerThread][4];
  int L[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) px[i] = static_cast<float>(patch.tx + i) + 0.5f;
  if constexpr (kPerThread == 4) {  // 16-byte loads: pix0 is a multiple of 4
    const float4 t4 = *reinterpret_cast<const float4*>(t_final + pix0);
    const float4 a4 = *reinterpret_cast<const float4*>(d_alpha + pix0);
    const int4 l4 = *reinterpret_cast<const int4*>(last + pix0);
    T[0] = t4.x, T[1] = t4.y, T[2] = t4.z, T[3] = t4.w;
    tail[0] = a4.x, tail[1] = a4.y, tail[2] = a4.z, tail[3] = a4.w;
    L[0] = l4.x, L[1] = l4.y, L[2] = l4.z, L[3] = l4.w;
    const float4* gp = reinterpret_cast<const float4*>(d_image + pix0 * n_ch);
    if (n_ch > 3) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = gp[i];
        g[i][0] = v.x, g[i][1] = v.y, g[i][2] = v.z, g[i][3] = v.w;
      }
    } else {
      const float4 v0 = gp[0], v1 = gp[1], v2 = gp[2];
      const float v[12] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                           v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        g[i][0] = v[3 * i], g[i][1] = v[3 * i + 1], g[i][2] = v[3 * i + 2], g[i][3] = 0.0f;
      }
    }
  } else {
    T[0] = t_final[pix0];
    tail[0] = d_alpha[pix0];
    L[0] = last[pix0];
    const float* gp = d_image + pix0 * n_ch;
    g[0][0] = gp[0], g[0][1] = gp[1], g[0][2] = gp[2];
    g[0][3] = n_ch > 3 ? gp[3] : 0.0f;
  }
  int my_last = -1;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    S[i] = 0.0f;
    tail[i] = -tail[i] * T[i];  // g_T * T_final
    my_last = max(my_last, L[i]);
  }
  const int warp_last = __reduce_max_sync(kFullMask, my_last);
  if (threadIdx.x == 0) s_walk = -1;
  __syncthreads();
  if (lane == 0) atomicMax(&s_walk, warp_last);  // a max: the same in any order
  __syncthreads();
  const int count = tile_count[tile];
  const int walk = min(s_walk + 1, count);
  // instances from `keep` on lie in the windows the trim drops (the window
  // base is the tile's start rounded down to a multiple of 128)
  const int keep = static_cast<int>(min((static_cast<long long>(tile_neff[tile]) << kTrimShift) -
                                             (start & ((1 << kTrimShift) - 1)),
                                         static_cast<long long>(count)));
  unsigned n_seen = 0, n_skipped = 0, n_reduced = 0, n_trimmed = 0;  // kStats, lane 0's counts

  for (int b_end = walk; b_end > 0; b_end -= kBatch) {
    const int b0 = max(b_end - kBatch, 0);
    const int nb = b_end - b0;
    __syncthreads();  // the previous batch's features and partials are read
    if (threadIdx.x < nb) {
      const int pos = start + b0 + threadIdx.x;
      const int gi = gaussian_idx[pos];
      const float mx = mean2d[2 * gi], my = mean2d[2 * gi + 1];
      const float a = conic[3 * gi], b = conic[3 * gi + 1], c = conic[3 * gi + 2];
      const float op = opacity[gi];
      s_xy[threadIdx.x] = make_float2(mx, my);
      s_conop[threadIdx.x] = make_float4(a, b, c, op);
      const float* cg = color + (size_t)gi * n_ch;
      s_col[threadIdx.x] = make_float4(cg[0], cg[1], cg[2], n_ch > 3 ? cg[3] : 0.0f);
      s_slot[threadIdx.x] = slot_layout[pos];
      s_mask[threadIdx.x] = 0u;
      float smax;
      float4 box;
      reach_2d(mx, my, a, b, c, op, smax, box);
      s_lim[threadIdx.x] = make_float2(smax, 1.0f / op);
      s_box[threadIdx.x] = box;
    }
    __syncthreads();

    // instances behind the warp's last counted one are skipped at once; the
    // trimmed tail's (jj >= keep - b0) come first and are replayed only:
    // alpha, T_i and S_i, which the rows in front need
    const int jj_top = min(nb - 1, warp_last - b0);
    for (int jj = jj_top; jj >= max(keep - b0, 0); --jj) {
      if constexpr (kStats) ++n_seen;
      if (patch.misses(s_box[jj])) {
        if constexpr (kStats) ++n_skipped;
        continue;
      }
      const int k = b0 + jj;
      const float2 xy = s_xy[jj];
      const float4 co = s_conop[jj];
      const float smax = s_lim[jj].x;
      const float4 raw = s_col[jj];
      const float4 col = make_float4(fmaxf(raw.x, 0.0f), fmaxf(raw.y, 0.0f),
                                     fmaxf(raw.z, 0.0f), fmaxf(raw.w, 0.0f));
      const float dy = __fsub_rn(xy.y, py);
      bool counted = false;  // kStats
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (k > L[i]) continue;
        const float dx = __fsub_rn(xy.x, px[i]);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                     __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float sigma =
            __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(co.y, dx), dy));
        if (sigma > smax || sigma < 0.0f) continue;
        const float a = fminf(__fmul_rn(co.w, expf(-sigma)), kMaxAlpha);
        if (a < kMinAlpha) continue;
        const float t_before = T[i] * __fdividef(1.0f, __fsub_rn(1.0f, a));
        S[i] += t_before * a * (col.x * g[i][0] + col.y * g[i][1] + col.z * g[i][2] +
                                col.w * g[i][3]);
        T[i] = t_before;
        if constexpr (kStats) counted = true;
      }
      if constexpr (kStats) n_trimmed += __any_sync(kFullMask, counted) ? 1u : 0u;
    }
    for (int jj = min(jj_top, keep - b0 - 1); jj >= 0; --jj) {
      const float4 box = s_box[jj];
      if constexpr (kStats) ++n_seen;
      if (patch.misses(box)) {
        if constexpr (kStats) ++n_skipped;
        continue;  // warp-uniform: the instance cannot reach this patch
      }
      const int k = b0 + jj;
      const float2 xy = s_xy[jj];
      const float4 co = s_conop[jj];
      const float2 lim = s_lim[jj];
      const float smax = lim.x;
      const float4 raw = s_col[jj];
      const float4 col = make_float4(fmaxf(raw.x, 0.0f), fmaxf(raw.y, 0.0f),
                                     fmaxf(raw.z, 0.0f), fmaxf(raw.w, 0.0f));
      float acc[kMaxF];
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) acc[f] = 0.0f;
      bool touched = false;
      const float dy = __fsub_rn(xy.y, py);
      float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f;  // sums of u, u dx, u dx^2
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (k > L[i]) continue;  // behind this pixel's last counted one
        const float dx = __fsub_rn(xy.x, px[i]);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                     __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float sigma =
            __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(co.y, dx), dy));
        if (sigma < 0.0f || sigma > smax) continue;  // above smax: alpha < 1/255
        const float a_raw = __fmul_rn(co.w, expf(-sigma));
        const float a = fminf(a_raw, kMaxAlpha);
        if (a < kMinAlpha) continue;
        // k <= L and not skipped: counted (the counted set is a prefix)
        touched = true;
        const float one_m = __fsub_rn(1.0f, a);
        const float r = __fdividef(1.0f, one_m);
        const float t_before = T[i] * r;
        const float w = t_before * a;
        const float cgv = col.x * g[i][0] + col.y * g[i][1] + col.z * g[i][2] +
                          col.w * g[i][3];
        const float dalpha = t_before * cgv - (S[i] + tail[i]) * r;
        acc[6] += w * g[i][0];
        acc[7] += w * g[i][1];
        acc[8] += w * g[i][2];
        acc[9] += w * g[i][3];
        if (a_raw < kMaxAlpha) {  // below the clamp: alpha depends on sigma, op
          const float u = -a * dalpha;  // dL/dsigma
          const float ux = u * dx;
          m0 += u;
          m1 += ux;
          m2 += ux * dx;
        }
        S[i] += w * cgv;
        T[i] = t_before;
      }
      if (!__any_sync(kFullMask, touched)) continue;
      if constexpr (kStats) ++n_reduced;
      // the geometry gradients from the thread's moments (one row: dy is shared)
      const float m0y = dy * m0;  // sum u dy
      acc[0] = co.x * m1 + co.y * m0y;
      acc[1] = co.z * m0y + co.y * m1;
      acc[2] = 0.5f * m2;
      acc[3] = dy * m1;
      acc[4] = 0.5f * dy * m0y;
      acc[5] = -m0 * lim.y;
      warp_reduce_scatter<kMaxF, 16>(acc, lane);
      if (col_out >= 0) s_part[warp][jj][col_out] = acc[0];
      if (lane == 0) atomicOr(&s_mask[jj], 1u << warp);  // bits: any order, one result
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < nb * n_f; idx += kThreads) {
      const int jj = idx / n_f;
      const int f = idx % n_f;
      const unsigned mask = s_mask[jj];
      if (mask == 0u) continue;  // no pixel counts it: the row stays 0
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if ((mask >> w) & 1u) v += s_part[w][jj][f];
      if (f >= 6 && reinterpret_cast<const float*>(&s_col[jj])[f - 6] <= 0.0f)
        v = 0.0f;  // the colour clamp max(c, 0) passes no gradient below 0
      out[(size_t)s_slot[jj] * n_f + f] = v;
    }
  }
  if constexpr (kStats) {
    if (lane == 0) {  // integer counts: any order, one result
      atomicAdd(&stats[0], static_cast<unsigned long long>(n_seen));
      atomicAdd(&stats[1], static_cast<unsigned long long>(n_skipped));
      atomicAdd(&stats[2], static_cast<unsigned long long>(n_reduced));
      atomicAdd(&stats[3], static_cast<unsigned long long>(n_trimmed));
    }
  }
}

}  // namespace

// `stats` (null on the training path) selects the counting instance: it
// adds to [4] the (warp, instance) pairs walked, those the reach test
// skipped, those that ended in a reduction, and those in the trimmed tail
// that a pixel of the warp counts (the reductions the trim saves).
// `order_scratch` is room for grid_w * grid_h ints.
extern "C" int lfs_blend_backward(const void* tile_start, const void* tile_count, const void* gaussian_idx,
                                  const void* slot_layout, const void* mean2d,
                                  const void* conic, const void* opacity, const void* color,
                                  int n_ch, int grid_w, int grid_h, int tile_size,
                                  const void* t_final, const void* last, const void* tile_neff,
                                  const void* d_image, const void* d_alpha, void* out, void* stats,
                                  void* order_scratch, void* stream) {
  if (tile_size != 16 && tile_size != 32) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = grid_w * grid_h;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto rank = tile_size == 16
                        ? (stats ? heaviest_first<blend_backward_kernel<16, true>>
                                 : heaviest_first<blend_backward_kernel<16, false>>)
                        : (stats ? heaviest_first<blend_backward_kernel<32, true>>
                                 : heaviest_first<blend_backward_kernel<32, false>>);
  const int* order =
      rank(static_cast<const int*>(tile_count), n_tiles, static_cast<int*>(order_scratch), s);
  auto kernel = tile_size == 16
                    ? (stats ? blend_backward_kernel<16, true> : blend_backward_kernel<16, false>)
                    : (stats ? blend_backward_kernel<32, true> : blend_backward_kernel<32, false>);
  kernel<<<n_tiles, kThreads, 0, s>>>(
      order, static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(gaussian_idx), static_cast<const int*>(slot_layout),
      static_cast<const float*>(mean2d), static_cast<const float*>(conic),
      static_cast<const float*>(opacity), static_cast<const float*>(color), n_ch, grid_w,
      static_cast<const float*>(t_final), static_cast<const int*>(last),
      static_cast<const int*>(tile_neff), static_cast<const float*>(d_image), static_cast<const float*>(d_alpha),
      static_cast<float*>(out), static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}
