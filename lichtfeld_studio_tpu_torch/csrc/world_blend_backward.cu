// Kernel P6: the exact world-space (3DGUT) tile blend, backward: per-instance
// gradients of every stream row.
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/world_blend_pallas.py
// (_backward_kernel, entry _backward_call <- _world_bwd2). The TPU kernel
// replays each tile front to back in chunks with prefix scans, contracts
// the per-pixel terms into moments on the MXU, packs colour gradients as
// bf16 pairs, writes rows in SORTED order with a boundary head merge, and
// needs a restore sort (sort_rows_to_slot_order) before the reduction.
//
// What it computes (unchanged by the redesign for the H100):
//
//   * each pixel starts at its last counted contribution (P5's training
//     output) with T = T_final and walks the tile's range BACK to front;
//     T before contribution i is T_(i+1) / (1 - alpha_i), safe because the
//     0.999 clamp keeps 1 - alpha >= 1e-3; the colour behind,
//     S_i = sum_(j>i) w_j (c_j . g), is a running sum;
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
//     the (pixel, instance) evaluation is P5's (world_blend_common.cuh), so
//     the keep tests fall as in the forward;
//   * each instance's row is written to its PRE-SORT slot,
//     out[slot_layout[i]]: each instance lies in exactly one tile, so writes
//     never collide, and the rows land where P4's segments expect them. No
//     restore sort. Rows that no pixel counts are not written (the caller
//     zeroes them).
//
// What bounds it on the H100, and the design. The bound (chip_smoke.py)
// counts 60 float32 operations to bound an instance over a warp's patch,
// P5's 44 (65 rolling) to replay and test each (pixel, instance) pair
// inside a patch the bound keeps, and 79 more (106 rolling) for a counted
// one. What the kernel pays for besides: a warp
// that owns pixels an instance cannot reach still evaluates it down to
// each pixel's `last`, and a warp with one counting lane reduces every
// column across its lanes. So, after P3 (csrc/blend_backward.cu):
//
//   * one 256-thread block per tile; each WARP owns a compact patch of it
//     (blend_common.cuh: 16 x 8 pixels of a 32-px tile, 4 in a row a
//     thread, their rays, times, T_final, `last` and cotangents loaded as
//     16-byte vectors; 8 x 4 of a 16-px tile);
//   * a (warp, instance) skip in RAY space (world_blend_common.cuh, shared
//     with P5). P3's 2D ellipse box does not carry over: a fisheye pixel
//     grid is not affine in the ray. The bound takes the patch's centre
//     ray and spread and each instance's |C'|_F and |M|_F (stored with its
//     row at the gather), one evaluation a (warp, instance) in place of
//     128, and the warp's lanes bound the batch's 32 instances at once
//     (lane j instance j, one ballot). The warp skips the instance when no
//     pixel of the patch can keep it, so none counts it;
//   * a warp that counted reduce-scatters 32 columns in 31 shuffles, in a
//     fixed order (blend_common.cuh; a global-shutter row's 24 padded with
//     zeros: a reduction of its 23 live columns in 24 shuffles measured no
//     faster, PERF.md), lane c ends with column c, and sets its bit in the
//     instance's mask; after the batch the block adds, for each instance,
//     the partials of the warps in its mask in warp order: deterministic,
//     no float atomics;
//   * a counted pair takes one reciprocal of 1 - alpha, shared by T_i and
//     dL/dalpha (two divisions before);
//   * batches of 32 instances, each gathered by one thread as 16-byte
//     vectors of its stream row; three blocks an SM at a global shutter
//     (registers capped at 80, a few spilled: two blocks measured 10%
//     slower), two at a rolling one;
//   * where the tiles outnumber the blocks the card holds at once, they run
//     heaviest first (blend_common.cuh's ranking, into the caller's
//     scratch of grid_w * grid_h ints).
//
// The counting instance (lfs_world_blend_backward_stats, a diagnostic)
// adds to stats[4] the (warp, instance) pairs walked, those the ray-space
// bound skipped, the (pixel, instance) pairs inside skipped ones that P5
// counted (0 unless the bound is not conservative), and the pairs that
// ended in a warp reduction.

#include "blend_common.cuh"
#include "world_blend_common.cuh"

namespace {

using namespace lfs_world;
using lfs_blend::kFullMask;
using lfs_blend::kWarps;
using lfs_blend::Patch;

constexpr int kBatch = 32;  // at most a warp's lanes: lane j bounds instance j
static_assert(kBatch <= 32, "one lane an instance for the skip ballot");
constexpr int kBlocksPerSm = 3;    // global shutter: registers capped at 80
constexpr int kBlocksPerSmRS = 2;  // rolling: 32 accumulators, capped at 128

template <int kTile, bool kRS, bool kStats>
__global__ void __launch_bounds__(kThreads, kRS ? kBlocksPerSmRS : kBlocksPerSm)
    world_blend_backward_kernel(const int* __restrict__ tile_order,  // null: tile order
                                const int* __restrict__ tile_start,
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
                                float* __restrict__ out,            // [cap, kRows]
                                unsigned long long* __restrict__ stats) {  // kStats: [4]
  using L = Layout<kRS>;
  using P = Patch<kTile>;
  constexpr int kQuads = L::kRows / 4;
  constexpr int kPerThread = P::kPerThread;
  constexpr int kCols = 32;  // reduce-scattered: lane c ends with column c
  constexpr int kDC1 = 9;    // rolling shutter: first dC1' column
  __shared__ float4 s_f[kBatch][kQuads];
  __shared__ float4 s_norm[kBatch];  // |C'|_F (rolling |C0'|_F), |C1'|_F, |M|_F
  __shared__ int s_slot[kBatch];
  __shared__ unsigned s_mask[kBatch];  // warps that hold a partial
  __shared__ float s_part[kWarps][kBatch][kCols];
  __shared__ int s_walk;

  const int tile = tile_order ? tile_order[blockIdx.x] : blockIdx.x;
  const int start = tile_start[tile];
  const int wp = grid_w * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const P patch(tile, grid_w, warp, lane);
  const size_t pix0 = (size_t)patch.ty * wp + patch.tx;

  float d[kPerThread][3], tp[kPerThread], T[kPerThread], S[kPerThread];
  float tail[kPerThread], g[kPerThread][4];
  int Lk[kPerThread];
  if constexpr (kPerThread == 4) {  // 16-byte loads: pix0 is a multiple of 4
    const float4* r4 = reinterpret_cast<const float4*>(rays_d + 3 * pix0);
    const float4 r0 = r4[0], r1 = r4[1], r2 = r4[2];
    const float r[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
    const float4 t4 = *reinterpret_cast<const float4*>(t_final + pix0);
    const float4 a4 = *reinterpret_cast<const float4*>(d_alpha + pix0);
    const int4 l4 = *reinterpret_cast<const int4*>(last + pix0);
    const float4 u4 = kRS ? *reinterpret_cast<const float4*>(tau + pix0) : make_float4(0, 0, 0, 0);
    const float t[4] = {t4.x, t4.y, t4.z, t4.w}, al[4] = {a4.x, a4.y, a4.z, a4.w};
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
    const int l[4] = {l4.x, l4.y, l4.z, l4.w};
    const float4* gp = reinterpret_cast<const float4*>(d_image + pix0 * n_ch);
    float gv[16];
    if (n_ch > 3) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = gp[q];
        gv[4 * q] = v.x, gv[4 * q + 1] = v.y, gv[4 * q + 2] = v.z, gv[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 v = gp[q];
        gv[4 * q] = v.x, gv[4 * q + 1] = v.y, gv[4 * q + 2] = v.z, gv[4 * q + 3] = v.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) d[i][j] = r[3 * i + j];
      tp[i] = u[i];
      T[i] = t[i];
      tail[i] = al[i];
      Lk[i] = l[i];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        g[i][c] = n_ch > 3 ? gv[4 * i + c] : (c < 3 ? gv[3 * i + c] : 0.0f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) d[0][j] = rays_d[3 * pix0 + j];
    tp[0] = kRS ? tau[pix0] : 0.0f;
    T[0] = t_final[pix0];
    tail[0] = d_alpha[pix0];
    Lk[0] = last[pix0];
#pragma unroll
    for (int c = 0; c < 4; ++c) g[0][c] = c < n_ch ? d_image[pix0 * n_ch + c] : 0.0f;
  }
  int my_last = -1;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    S[i] = 0.0f;
    tail[i] = -tail[i] * T[i];  // g_T * T_final
    my_last = max(my_last, Lk[i]);
  }

  // the patch in ray space (world_blend_common.cuh)
  const RayPatch rp = ray_patch<kPerThread>(d, tp);

  const int warp_last = __reduce_max_sync(kFullMask, my_last);
  if (threadIdx.x == 0) s_walk = -1;
  __syncthreads();
  if (lane == 0) atomicMax(&s_walk, warp_last);  // a max: the same in any order
  __syncthreads();
  const int walk = min(s_walk + 1, tile_count[tile]);
  unsigned n_seen = 0, n_skipped = 0, n_lost = 0, n_reduced = 0;  // kStats

  for (int b_end = walk; b_end > 0; b_end -= kBatch) {
    const int b0 = max(b_end - kBatch, 0);
    const int nb = b_end - b0;
    __syncthreads();  // the previous batch's rows and partials are read
    if (threadIdx.x < nb) {
      const int pos = start + b0 + threadIdx.x;
      const float4* src =
          reinterpret_cast<const float4*>(stream + (size_t)gaussian_idx[pos] * L::kRows);
      float row[L::kRows];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 v = src[q];
        s_f[threadIdx.x][q] = v;
        row[4 * q] = v.x, row[4 * q + 1] = v.y, row[4 * q + 2] = v.z, row[4 * q + 3] = v.w;
      }
      s_norm[threadIdx.x] = row_norms<kRS>(row);
      s_slot[threadIdx.x] = slot_layout[pos];
      s_mask[threadIdx.x] = 0u;
    }
    __syncthreads();

    // the batch's instances this warp walks (none behind its last counted
    // one) and those it skips: lane j bounds instance j, one ballot each
    const bool walks = lane < nb && b0 + lane <= warp_last;
    const unsigned walk_mask = __ballot_sync(kFullMask, walks);
    const unsigned skip_mask = __ballot_sync(
        kFullMask,
        walks && ray_bound<kRS>(rp, reinterpret_cast<const float*>(&s_f[lane][0]), s_norm[lane]).skip);
    if constexpr (kStats) {
      n_seen += __popc(walk_mask);
      n_skipped += __popc(skip_mask);
      for (unsigned m = skip_mask; m != 0u; m &= m - 1u) {
        const int k = b0 + __ffs(m) - 1;
        const float* f = reinterpret_cast<const float*>(&s_f[k - b0][0]);
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
          if (k <= Lk[i] && world_eval<kRS>(f, d[i][0], d[i][1], d[i][2], tp[i]).s <= kLog2MaxS)
            ++n_lost;
      }
    }
    // back to front through the instances that may count
    for (unsigned todo = walk_mask & ~skip_mask; todo != 0u;) {
      const int jj = 31 - __clz(todo);
      todo &= ~(1u << jj);
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
        const float r = 1.0f / __fsub_rn(1.0f, a);  // shared by T_i and dL/dalpha
        const float t_before = T[i] * r;
        const float w = t_before * a;
        const float cgv = col[0] * g[i][0] + col[1] * g[i][1] + col[2] * g[i][2] +
                          col[3] * g[i][3];
        const float dalpha = t_before * cgv - (S[i] + tail[i]) * r;
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
      if (!__any_sync(kFullMask, touched)) continue;
      if constexpr (kStats) ++n_reduced;
      lfs_blend::warp_reduce_scatter<kCols, 16>(acc, lane);
      s_part[warp][jj][lane] = acc[0];
      if (lane == 0) atomicOr(&s_mask[jj], 1u << warp);  // bits: any order, one result
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < nb * L::kRows; idx += kThreads) {
      const int jj = idx / L::kRows;
      const int c = idx % L::kRows;
      const unsigned mask = s_mask[jj];
      if (mask == 0u) continue;  // no pixel counts it: stays 0
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if ((mask >> w) & 1u) v += s_part[w][jj][c];
      const float* f = reinterpret_cast<const float*>(&s_f[jj][0]);
      if (c >= L::kColor && c < L::kColor + 4 && f[c] <= 0.0f)
        v = 0.0f;  // the colour clamp max(c, 0) passes no gradient below 0
      out[(size_t)s_slot[jj] * L::kRows + c] = v;
    }
  }
  if constexpr (kStats) {
    n_lost = __reduce_add_sync(kFullMask, n_lost);
    if (lane == 0) {  // integer counts: any order, one result
      atomicAdd(&stats[0], static_cast<unsigned long long>(n_seen));
      atomicAdd(&stats[1], static_cast<unsigned long long>(n_skipped));
      atomicAdd(&stats[2], static_cast<unsigned long long>(n_lost));
      atomicAdd(&stats[3], static_cast<unsigned long long>(n_reduced));
    }
  }
}

template <int kTile, bool kRS, bool kStats>
int launch(const void* tile_start, const void* tile_count, const void* gaussian_idx,
           const void* slot_layout, const void* stream, const void* rays_d, const void* tau,
           int n_ch, int grid_w, int grid_h, const void* t_final, const void* last,
           const void* d_image, const void* d_alpha, void* out, void* stats, void* order_scratch,
           cudaStream_t s) {
  const int n_tiles = grid_w * grid_h;
  constexpr auto kernel = world_blend_backward_kernel<kTile, kRS, kStats>;
  const int* order = lfs_blend::heaviest_first<kernel>(
      static_cast<const int*>(tile_count), n_tiles, static_cast<int*>(order_scratch), s);
  kernel<<<n_tiles, kThreads, 0, s>>>(
      order, static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(gaussian_idx), static_cast<const int*>(slot_layout),
      static_cast<const float*>(stream), static_cast<const float*>(rays_d),
      static_cast<const float*>(tau), n_ch, grid_w, static_cast<const float*>(t_final),
      static_cast<const int*>(last), static_cast<const float*>(d_image),
      static_cast<const float*>(d_alpha), static_cast<float*>(out),
      static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}

template <bool kStats>
int launch_any(const void* tile_start, const void* tile_count, const void* gaussian_idx,
               const void* slot_layout, const void* stream, int n_rows, const void* rays_d,
               const void* tau, int n_ch, int grid_w, int grid_h, int tile_size,
               const void* t_final, const void* last, const void* d_image, const void* d_alpha,
               void* out, void* stats, void* order_scratch, void* cuda_stream) {
  const bool rs = n_rows == 32;
  if ((tile_size != 16 && tile_size != 32) || (n_rows != 24 && n_rows != 32) || n_ch < 3 ||
      n_ch > 4 || (tau != nullptr) != rs)
    return static_cast<int>(cudaErrorInvalidValue);
  auto fn = tile_size == 16 ? (rs ? launch<16, true, kStats> : launch<16, false, kStats>)
                            : (rs ? launch<32, true, kStats> : launch<32, false, kStats>);
  return fn(tile_start, tile_count, gaussian_idx, slot_layout, stream, rays_d, tau, n_ch, grid_w,
            grid_h, t_final, last, d_image, d_alpha, out, stats, order_scratch,
            static_cast<cudaStream_t>(cuda_stream));
}

}  // namespace

// `order_scratch` is room for grid_w * grid_h ints.
extern "C" int lfs_world_blend_backward(const void* tile_start, const void* tile_count,
                                        const void* gaussian_idx, const void* slot_layout,
                                        const void* stream, int n_rows, const void* rays_d,
                                        const void* tau, int n_ch, int grid_w, int grid_h,
                                        int tile_size, const void* t_final, const void* last,
                                        const void* d_image, const void* d_alpha, void* out,
                                        void* order_scratch, void* cuda_stream) {
  return launch_any<false>(tile_start, tile_count, gaussian_idx, slot_layout, stream, n_rows,
                           rays_d, tau, n_ch, grid_w, grid_h, tile_size, t_final, last, d_image,
                           d_alpha, out, nullptr, order_scratch, cuda_stream);
}

// The counting instance: lfs_world_blend_backward's arguments with `stats`
// (unsigned long long [4], added to; see the header) before the scratch.
extern "C" int lfs_world_blend_backward_stats(const void* tile_start, const void* tile_count,
                                              const void* gaussian_idx, const void* slot_layout,
                                              const void* stream, int n_rows, const void* rays_d,
                                              const void* tau, int n_ch, int grid_w, int grid_h,
                                              int tile_size, const void* t_final, const void* last,
                                              const void* d_image, const void* d_alpha, void* out,
                                              void* stats, void* order_scratch, void* cuda_stream) {
  return launch_any<true>(tile_start, tile_count, gaussian_idx, slot_layout, stream, n_rows,
                          rays_d, tau, n_ch, grid_w, grid_h, tile_size, t_final, last, d_image,
                          d_alpha, out, stats, order_scratch, cuda_stream);
}
