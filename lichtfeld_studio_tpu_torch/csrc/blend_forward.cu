// Kernel P2: forward tile blend, for inference renders and for training.
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/blend_pallas.py
// (_forward_kernel, entry _forward_call <- blend_pallas_fused) in both its
// variants (compact layout, aligned=False): inference (freeze=False) and
// training (freeze=True). The TPU kernel streams a pre-gathered [8, I]
// instance stream with bf16 colour pairs and evaluates alpha as an MXU
// matmul against a quadratic pixel basis; both were answers to TPU limits.
//
// What it computes (unchanged by the redesign for the H100):
//
//   * each pixel composites its tile's depth-sorted instances front to
//     back: sigma = 0.5(a dx^2 + c dy^2) + b dx dy with dx = mean - pixel
//     (pixel centres at +0.5), skipped when sigma < 0;
//     alpha = min(0.999, op exp(-sigma)), skipped when alpha < 1/255;
//     colours are clamped to >= 0; a contribution counts only while
//     T (1 - alpha) >= 1e-4 (the reference done flag); the inference
//     variant also stops a pixel right after a counted contribution leaves
//     T < threshold (1/512, the early stop), the training variant has no
//     early stop, so the done flag is its only rule, as the TPU kernel's
//     freeze=True;
//   * the training variant (template flag kTrain, chosen by the caller
//     passing the two extra outputs) writes two more values per pixel: the
//     final transmittance T (not 1 - alpha, which loses T's low bits) and
//     the index within the tile's range of the last counted contribution
//     (-1 if none), upstream's n_contrib. The blend backward (P3) starts
//     its back-to-front walk there;
//   * the training variant also records the backward's tail trim (the TPU
//     kernel's GRAD_SKIP_EPS, blend_pallas.py:74-86, :374-379, :956-971):
//     per 128-instance window of the global sorted order (the TPU
//     backward's chunks on the compact layout: base = start - start % 128),
//     a pixel's weight T_entry - T_exit; at its done crossing the pixel's T
//     drops to the crossing product, as the TPU kernel's unfrozen product
//     does, and the pixel stops there. The tile's n_eff is 1 + the last
//     window in which some pixel's weight is >= eps, at least 1, and
//     "every window" (1 << 30) where eps is 0 or the tile has more windows
//     than pixels (where the TPU kernel's lane record overflows). A warp
//     closes its pixels' window when its walk reaches an instance in reach
//     past the window's end (one compare a (warp, instance) pair, warp-
//     uniform; the windows between weigh 0, since no T changed there), a
//     pixel's at its done crossing, and all at the end; the tile's maximum
//     is a warp max and a block max of integers, one store a tile. A
//     skipped pair changes no T, so it adds no weight;
//   * sigma, alpha and the transmittance step are written with __fmul_rn /
//     __fadd_rn (never contracted into an FMA), in the operation order of
//     the plain version (ops/blend_ref.py), so the skip and termination
//     tests fall on the same side as the plain version's on the same inputs.
//
// Termination against the TPU inference kernel: that kernel drops the done
// flag, accumulates unfrozen and stops per tile at 128-instance
// granularity once every pixel's T < 1/512. Here each pixel stops on its
// own at the first counted T < 1/512. Either way what is left out of a
// pixel is at most its transmittance at the stop, < 1/512
// (INFERENCE_TERM_THRESHOLD, blend_pallas.py:177-182, :432-434), so both
// lie within 1/512 of the reference compositing at 1e-4. Moving the done
// flag itself to 1/512 would not keep that bound: a 0.999-alpha gaussian
// in front of an empty pixel leaves T = 0.001 < 1/512 and would be
// dropped whole.
//
// What bounds it on the H100, and the design. The bound (chip_smoke.py)
// counts the blend arithmetic the data needs: 4 float32 operations to test
// an instance against a warp's patch, 10 (sigma and its limits) for each
// (pixel, instance) pair inside a patch the reach keeps, 19 more (one
// expf) where the pair counts. What the kernel pays for besides is
// latency: each pixel's walk is a serial chain in depth (T3 measured the
// serial walk 3-4x faster than scans across lanes, so it stays serial in
// the thread that owns the pixel), and every pair a warp evaluates that
// cannot count costs its evaluation all the same. So:
//
//   * one 256-thread block per tile, each WARP on a compact patch of it
//     (blend_common.cuh: 16 x 8 pixels of a 32-px tile, 4 in a row a
//     thread, or 8 x 4 of a 16-px tile), the patches of the backward (P3);
//   * the block gathers the tile's instances in batches of 256, one thread
//     an instance, through gaussian_idx into shared memory (no gathered
//     stream in device memory), into two slots: right after a batch's
//     barrier each thread loads its instance of the next batch into the
//     other slot, clamps its colour and stores its reach beside it
//     (blend_common.cuh: the sigma limit above which op exp(-sigma) <
//     1/255 and the bounding box of that ellipse, both with margins), then
//     walks this batch; one barrier a batch. The owner index is loaded a
//     batch ahead. (Copies in flight during the walk, a cp.async ring,
//     measured no faster: PERF.md.);
//   * a warp whose patch the box misses skips the instance with one
//     compare, a pair above the sigma limit skips before expf. A skipped
//     pair would not have counted, so it changes neither T nor the done
//     flag: the counted set, the image, T_final and `last` are the same;
//   * a warp whose pixels are all done skips the walk of the batches left
//     (a vote a batch; a vote an instance cost more than it saved); the
//     block stops gathering once every pixel is done;
//   * where the tiles outnumber the blocks the card holds at once, they run
//     heaviest first (blend_common.cuh's ranking, into the caller's
//     scratch of grid_w * grid_h ints).
//
// The counting instance (lfs_blend_forward_stats, a diagnostic) adds to
// stats[3] the (warp, instance) pairs walked, those the reach box skipped,
// and the (pixel, instance) pairs inside skipped ones that would have
// passed the alpha test: 0 unless the reach is not conservative.

#include "blend_common.cuh"

namespace {

// using-declarations, not a using-directive: the header's own anonymous
// namespace must stay out of this file's unqualified lookup
using lfs_blend::heaviest_first;
using lfs_blend::kFullMask;
using lfs_blend::kFullReplay;
using lfs_blend::kThreads;
using lfs_blend::kTrimShift;
using lfs_blend::Patch;
using lfs_blend::reach_2d;

constexpr int kBatch = kThreads;  // one instance a thread
constexpr int kBlocksPerSm = 4;
constexpr float kMaxAlpha = 0.999f;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kDoneThreshold = 1e-4f;  // TRANSMITTANCE_THRESHOLD

// sigma of a (pixel, instance) pair in the plain version's operation order;
// cyy = (c dy) dy is the same for a thread's pixels (one row)
__device__ __forceinline__ float pair_sigma(float4 co, float dx, float dy, float cyy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx), cyy);
  return __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(co.y, dx), dy));
}

template <int kTile, bool kTrain, bool kStats>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    blend_forward_kernel(const int* __restrict__ tile_order,  // null: tile order
                         const int* __restrict__ tile_start,
                         const int* __restrict__ tile_count,
                         const int* __restrict__ gaussian_idx,
                         const float* __restrict__ mean2d,   // [N, 2]
                         const float* __restrict__ conic,    // [N, 3]
                         const float* __restrict__ opacity,  // [N]
                         const float* __restrict__ color,    // [N, n_ch]
                         int n_ch, int grid_w, float threshold, float eps,
                         float* __restrict__ image,    // [Hp, Wp, n_ch]
                         float* __restrict__ alpha,    // [Hp, Wp]
                         float* __restrict__ t_final,  // [Hp, Wp], kTrain only
                         int* __restrict__ last,       // [Hp, Wp], kTrain only
                         int* __restrict__ tile_neff,  // [tiles], kTrain only
                         unsigned long long* __restrict__ stats) {  // kStats: [3]
  using P = Patch<kTile>;
  constexpr int kPerThread = P::kPerThread;
  __shared__ float2 s_xy[2][kBatch];
  __shared__ float4 s_conop[2][kBatch];
  __shared__ float4 s_col[2][kBatch];  // clamped to >= 0
  __shared__ float4 s_box[2][kBatch];  // pixel centres the instance can reach: x, x, y, y
  __shared__ float s_smax[2][kBatch];  // sigma above which alpha < 1/255
  __shared__ int s_last_heavy[lfs_blend::kWarps];  // kTrain: each warp's last window >= eps

  const int tile = tile_order ? tile_order[blockIdx.x] : blockIdx.x;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const P patch(tile, grid_w, warp, lane);
  const float py = static_cast<float>(patch.ty) + 0.5f;

  float px[kPerThread], T[kPerThread];
  float acc[kPerThread][4];
  float t_entry[kPerThread];  // kTrain: T where the warp's current window began
  int last_k[kPerThread];
  bool done[kPerThread];
  const int off = start & ((1 << kTrimShift) - 1);  // the tile's place in its first window
  const bool trim = kTrain && eps > 0.0f;
  int last_heavy = -1;  // the last window in which one of this thread's pixels weighs >= eps
  int win = 0;          // the window of the warp's walk (warp-uniform) and where it ends
  int win_end = (1 << kTrimShift) - off;
  // the window `win` ends for this thread's pixels: each weighs T at its entry less T now
  auto close_window = [&]() {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (__fsub_rn(t_entry[i], T[i]) >= eps) last_heavy = max(last_heavy, win);
      t_entry[i] = T[i];
    }
  };
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    px[i] = static_cast<float>(patch.tx + i) + 0.5f;
    T[i] = 1.0f;
    t_entry[i] = 1.0f;
    last_k[i] = -1;
    done[i] = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }
  unsigned n_seen = 0, n_skipped = 0, n_lost = 0;  // kStats

  // this thread's instance g of a batch into slot `slot`: its colour
  // clamped, its reach beside it
  auto gather = [&](int slot, int g) {
    const float2 xy = *reinterpret_cast<const float2*>(mean2d + 2 * (size_t)g);
    const float* cg = conic + 3 * (size_t)g;
    const float4 co = make_float4(cg[0], cg[1], cg[2], opacity[g]);
    float4 col;
    if (n_ch > 3) {
      col = *reinterpret_cast<const float4*>(color + 4 * (size_t)g);
    } else {
      const float* src = color + 3 * (size_t)g;
      col = make_float4(src[0], src[1], src[2], 0.0f);
    }
    s_xy[slot][threadIdx.x] = xy;
    s_conop[slot][threadIdx.x] = co;
    s_col[slot][threadIdx.x] = make_float4(fmaxf(col.x, 0.0f), fmaxf(col.y, 0.0f),
                                           fmaxf(col.z, 0.0f), fmaxf(col.w, 0.0f));
    reach_2d(xy.x, xy.y, co.x, co.y, co.z, co.w, s_smax[slot][threadIdx.x],
             s_box[slot][threadIdx.x]);
  };
  // (pixel, instance) pairs that would pass the alpha test (kStats)
  auto would_count = [&](float2 xy, float4 co) {
    const float dy = __fsub_rn(xy.y, py);
    const float cyy = __fmul_rn(__fmul_rn(co.z, dy), dy);
    unsigned n = 0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const float sigma = pair_sigma(co, __fsub_rn(xy.x, px[i]), dy, cyy);
      if (!done[i] && sigma >= 0.0f && fminf(__fmul_rn(co.w, expf(-sigma)), kMaxAlpha) >= kMinAlpha)
        ++n;
    }
    return n;
  };

  if (threadIdx.x < count) gather(0, gaussian_idx[start + threadIdx.x]);
  int g_next = kBatch + threadIdx.x < count ? gaussian_idx[start + kBatch + threadIdx.x] : 0;

  for (int b0 = 0, slot = 0; b0 < count; b0 += kBatch, slot ^= 1) {
    bool all_mine = true;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) all_mine = all_mine && done[i];
    // the batch is in place for every warp, and every warp has left the
    // previous one, whose slot the next batch takes
    if (__syncthreads_count(all_mine) == kThreads) break;
    const int k_next = b0 + kBatch + threadIdx.x;
    if (k_next < count) gather(slot ^ 1, g_next);
    if (k_next + kBatch < count) g_next = gaussian_idx[start + k_next + kBatch];

    const int nb = min(kBatch, count - b0);
    const bool warp_done = __all_sync(kFullMask, all_mine);  // this warp's pixels are all done
    // 32 instances at a time: lane i tests instance q + i against the
    // patch, one ballot; the warp walks the ones in reach, front to back
    for (int q = 0; q < nb && !warp_done; q += 32) {
      const bool valid = q + lane < nb;
      const unsigned in_reach =
          __ballot_sync(kFullMask, valid && !patch.misses(s_box[slot][q + lane]));
      if constexpr (kStats) {
        const unsigned walked = __ballot_sync(kFullMask, valid);
        n_seen += __popc(walked);
        n_skipped += __popc(walked & ~in_reach);
        for (unsigned m = walked & ~in_reach; m != 0u; m &= m - 1u) {
          const int j = q + __ffs(m) - 1;
          n_lost += would_count(s_xy[slot][j], s_conop[slot][j]);
        }
      }
      for (unsigned todo = in_reach; todo != 0u; todo &= todo - 1u) {
        const int j = q + __ffs(todo) - 1;
        if (trim && b0 + j >= win_end) {  // warp-uniform: the walk has left window `win`
          close_window();
          win = (off + b0 + j) >> kTrimShift;
          win_end = ((win + 1) << kTrimShift) - off;
        }
        const float2 xy = s_xy[slot][j];
        const float4 co = s_conop[slot][j];
        const float smax = s_smax[slot][j];
        const float dy = __fsub_rn(xy.y, py);
        const float cyy = __fmul_rn(__fmul_rn(co.z, dy), dy);
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          if (done[i]) continue;
          const float sigma = pair_sigma(co, __fsub_rn(xy.x, px[i]), dy, cyy);
          if (sigma < 0.0f || sigma > smax) {  // above smax: alpha < 1/255
            if constexpr (kStats)
              n_lost += sigma > smax && __fmul_rn(co.w, expf(-sigma)) >= kMinAlpha ? 1u : 0u;
            continue;
          }
          const float a = fminf(__fmul_rn(co.w, expf(-sigma)), kMaxAlpha);
          if (a < kMinAlpha) continue;
          const float next_t = __fmul_rn(T[i], __fsub_rn(1.0f, a));
          if (next_t < kDoneThreshold) {  // reference done flag
            // the crossing ends the pixel's walk and its window
            if (trim && __fsub_rn(t_entry[i], next_t) >= eps) last_heavy = max(last_heavy, win);
            done[i] = true;
            continue;
          }
          const float w = __fmul_rn(T[i], a);
          const float4 col = s_col[slot][j];
          acc[i][0] += w * col.x;
          acc[i][1] += w * col.y;
          acc[i][2] += w * col.z;
          acc[i][3] += w * col.w;
          T[i] = next_t;
          if constexpr (kTrain) {
            last_k[i] = b0 + j;
          } else if (next_t < threshold) {
            done[i] = true;  // inference early stop
          }
        }
      }
    }
  }

  if constexpr (kTrain) {  // the tail trim's n_eff: the last window any pixel weighs >= eps in
    if (trim) close_window();
    last_heavy = __reduce_max_sync(kFullMask, last_heavy);
    if (lane == 0) s_last_heavy[warp] = last_heavy;
    __syncthreads();
    if (threadIdx.x == 0) {
      int heavy = -1;
      for (int w = 0; w < lfs_blend::kWarps; ++w) heavy = max(heavy, s_last_heavy[w]);
      const int n_windows = (off + count + (1 << kTrimShift) - 1) >> kTrimShift;
      tile_neff[tile] = !trim || n_windows > kTile * kTile ? kFullReplay : max(heavy + 1, 1);
    }
  }
  const size_t pix0 = (size_t)patch.ty * grid_w * kTile + patch.tx;
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
    if constexpr (kTrain) {
      *reinterpret_cast<float4*>(t_final + pix0) = make_float4(T[0], T[1], T[2], T[3]);
      *reinterpret_cast<int4*>(last + pix0) = make_int4(last_k[0], last_k[1], last_k[2], last_k[3]);
    }
  } else {
    float* out = image + pix0 * n_ch;
    out[0] = acc[0][0];
    out[1] = acc[0][1];
    out[2] = acc[0][2];
    if (n_ch > 3) out[3] = acc[0][3];
    alpha[pix0] = 1.0f - T[0];
    if constexpr (kTrain) {
      t_final[pix0] = T[0];
      last[pix0] = last_k[0];
    }
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

template <int kTile, bool kTrain, bool kStats>
int launch(const void* tile_start, const void* tile_count, const void* gaussian_idx,
           const void* mean2d, const void* conic, const void* opacity, const void* color,
           int n_ch, int grid_w, int grid_h, float threshold, float eps, void* image, void* alpha,
           void* t_final, void* last, void* tile_neff, void* stats, void* order_scratch,
           cudaStream_t s) {
  const int n_tiles = grid_w * grid_h;
  constexpr auto kernel = blend_forward_kernel<kTile, kTrain, kStats>;
  const int* order = heaviest_first<kernel>(static_cast<const int*>(tile_count), n_tiles,
                                            static_cast<int*>(order_scratch), s);
  kernel<<<n_tiles, kThreads, 0, s>>>(
      order, static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(gaussian_idx), static_cast<const float*>(mean2d),
      static_cast<const float*>(conic), static_cast<const float*>(opacity),
      static_cast<const float*>(color), n_ch, grid_w, threshold, eps, static_cast<float*>(image),
      static_cast<float*>(alpha), static_cast<float*>(t_final), static_cast<int*>(last),
      static_cast<int*>(tile_neff), static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}

template <bool kStats>
int launch_any(const void* tile_start, const void* tile_count, const void* gaussian_idx,
               const void* mean2d, const void* conic, const void* opacity, const void* color,
               int n_ch, int grid_w, int grid_h, int tile_size, float threshold, float eps,
               void* image, void* alpha, void* t_final, void* last, void* tile_neff, void* stats,
               void* order_scratch, void* stream) {
  const bool train = last != nullptr;
  if ((tile_size != 16 && tile_size != 32) || (t_final != nullptr) != train ||
      (tile_neff != nullptr) != train || n_ch < 3 || n_ch > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  auto fn = tile_size == 16 ? (train ? launch<16, true, kStats> : launch<16, false, kStats>)
                            : (train ? launch<32, true, kStats> : launch<32, false, kStats>);
  return fn(tile_start, tile_count, gaussian_idx, mean2d, conic, opacity, color, n_ch, grid_w,
            grid_h, threshold, eps, image, alpha, t_final, last, tile_neff, stats, order_scratch,
            static_cast<cudaStream_t>(stream));
}

}  // namespace

// `order_scratch` is room for grid_w * grid_h ints. t_final, last and
// tile_neff (int [grid_w * grid_h]) are all null (inference) or none
// (training, whose trim threshold is `eps`).
extern "C" int lfs_blend_forward(const void* tile_start, const void* tile_count,
                                 const void* gaussian_idx, const void* mean2d,
                                 const void* conic, const void* opacity,
                                 const void* color, int n_ch, int grid_w,
                                 int grid_h, int tile_size, float threshold, float eps,
                                 void* image, void* alpha, void* t_final,
                                 void* last, void* tile_neff, void* order_scratch, void* stream) {
  return launch_any<false>(tile_start, tile_count, gaussian_idx, mean2d, conic, opacity, color,
                           n_ch, grid_w, grid_h, tile_size, threshold, eps, image, alpha, t_final,
                           last, tile_neff, nullptr, order_scratch, stream);
}

// The counting instance: lfs_blend_forward's arguments and `stats`
// (unsigned long long [3], added to; see the header).
extern "C" int lfs_blend_forward_stats(const void* tile_start, const void* tile_count,
                                       const void* gaussian_idx, const void* mean2d,
                                       const void* conic, const void* opacity, const void* color,
                                       int n_ch, int grid_w, int grid_h, int tile_size,
                                       float threshold, float eps, void* image, void* alpha,
                                       void* t_final, void* last, void* tile_neff, void* stats,
                                       void* order_scratch, void* stream) {
  return launch_any<true>(tile_start, tile_count, gaussian_idx, mean2d, conic, opacity, color,
                          n_ch, grid_w, grid_h, tile_size, threshold, eps, image, alpha, t_final,
                          last, tile_neff, stats, order_scratch, stream);
}
