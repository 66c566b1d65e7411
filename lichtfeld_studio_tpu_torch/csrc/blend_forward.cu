// Kernel P2: forward tile blend, for inference renders and for training.
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/blend_pallas.py
// (_forward_kernel, entry _forward_call <- blend_pallas_fused) in both its
// variants (compact layout, aligned=False): inference (freeze=False) and
// training (freeze=True). The TPU kernel streams a pre-gathered [8, I]
// instance stream with bf16 colour pairs and evaluates alpha as an MXU
// matmul against a quadratic pixel basis; both were answers to TPU limits.
// This kernel is the upstream CUDA shape (fastgs blend_cu,
// kernels_forward.cuh:356-461):
//
//   * one 256-thread block per tile; the tile is 32x32 (4 pixels per
//     thread) or 16x16 (1 pixel per thread), a template parameter (pixel
//     p = threadIdx.x + 256 i, row-major within the tile, centre at +0.5);
//   * the block walks the tile's depth-sorted instance range in batches of
//     256: each thread reads one gaussian_idx and gathers that gaussian's
//     mean2d, conic, opacity and colour into shared memory itself, so no
//     gathered instance stream exists in device memory; colours stay f32
//     and are clamped to >= 0 when loaded;
//   * each pixel composites front to back: sigma = 0.5(a dx^2 + c dy^2)
//     + b dx dy with dx = mean - pixel, skipped when sigma < 0;
//     alpha = min(0.999, op exp(-sigma)), skipped when alpha < 1/255;
//     a contribution counts only while T (1 - alpha) >= 1e-4 (the
//     reference done flag, unchanged); the inference variant also stops
//     a pixel right after a counted contribution leaves T < threshold
//     (1/512, the early stop), the training variant has no early stop, so
//     the done flag is its only rule, as the TPU kernel's freeze=True;
//   * once every pixel of the block is done (__syncthreads_count) the
//     block stops walking;
//   * the training variant (template flag kTrain, chosen by the caller
//     passing the two extra outputs) writes two more values per pixel: the
//     final transmittance T (not 1 - alpha, which loses T's low bits) and
//     the index within the tile's range of the last counted contribution
//     (-1 if none), upstream's n_contrib. The blend backward (P3) starts
//     its back-to-front walk there. The inference variant carries none
//     of that bookkeeping in its inner loop.
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
// sigma, alpha and the transmittance step are written with __fmul_rn /
// __fadd_rn (never contracted into an FMA), in the operation order of the
// plain version (ops/blend_ref.py), so the skip and termination tests fall
// on the same side as the plain version's on the same inputs.
//
// Bound on the H100: per (pixel, walked instance) 16 float32 operations
// (one expf among them) to evaluate and test the pair, and 13 more where it
// counts, on a tile walk that is serial in depth; the per-instance gather is 40 B per
// walked instance per tile. At 1080p with ~1.7M instances the blend is
// compute- and latency-bound in the inner loop, not bandwidth-bound; the
// batch in shared memory serves 1024 pixels from one gather, and 4 pixels
// per thread reuse each shared-memory read four times.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = kThreads;
constexpr float kMaxAlpha = 0.999f;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kDoneThreshold = 1e-4f;  // TRANSMITTANCE_THRESHOLD

template <int kTile, bool kTrain>
__global__ void __launch_bounds__(kThreads)
    blend_forward_kernel(const int* __restrict__ tile_start,
                         const int* __restrict__ tile_count,
                         const int* __restrict__ gaussian_idx,
                         const float* __restrict__ mean2d,   // [N, 2]
                         const float* __restrict__ conic,    // [N, 3]
                         const float* __restrict__ opacity,  // [N]
                         const float* __restrict__ color,    // [N, n_ch]
                         int n_ch, int grid_w, float threshold,
                         float* __restrict__ image,    // [Hp, Wp, n_ch]
                         float* __restrict__ alpha,    // [Hp, Wp]
                         float* __restrict__ t_final,  // [Hp, Wp], kTrain only
                         int* __restrict__ last) {     // [Hp, Wp], kTrain only
  constexpr int kPerThread = kTile * kTile / kThreads;  // 4 or 1
  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_conop[kBatch];
  __shared__ float4 s_col[kBatch];

  const int tile = blockIdx.x;
  const int x0 = (tile % grid_w) * kTile;
  const int y0 = (tile / grid_w) * kTile;
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  float px[kPerThread], py[kPerThread], T[kPerThread];
  float acc[kPerThread][4];
  int last_k[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    px[i] = static_cast<float>(x0 + p % kTile) + 0.5f;
    py[i] = static_cast<float>(y0 + p / kTile) + 0.5f;
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
      s_xy[threadIdx.x] = make_float2(mean2d[2 * g], mean2d[2 * g + 1]);
      s_conop[threadIdx.x] = make_float4(conic[3 * g], conic[3 * g + 1],
                                         conic[3 * g + 2], opacity[g]);
      const float* cg = color + (size_t)g * n_ch;
      s_col[threadIdx.x] =
          make_float4(fmaxf(cg[0], 0.0f), fmaxf(cg[1], 0.0f), fmaxf(cg[2], 0.0f),
                      n_ch > 3 ? fmaxf(cg[3], 0.0f) : 0.0f);
    }
    __syncthreads();

    const int nb = min(kBatch, count - b0);
    for (int j = 0; j < nb; ++j) {
      const float2 xy = s_xy[j];
      const float4 co = s_conop[j];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (done[i]) continue;
        const float dx = __fsub_rn(xy.x, px[i]);
        const float dy = __fsub_rn(xy.y, py[i]);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                     __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float sigma =
            __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(co.y, dx), dy));
        if (sigma < 0.0f) continue;
        const float a = fminf(__fmul_rn(co.w, expf(-sigma)), kMaxAlpha);
        if (a < kMinAlpha) continue;
        const float next_t = __fmul_rn(T[i], __fsub_rn(1.0f, a));
        if (next_t < kDoneThreshold) {  // reference done flag
          done[i] = true;
          continue;
        }
        const float w = __fmul_rn(T[i], a);
        const float4 col = s_col[j];
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

  const int wp = grid_w * kTile;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const size_t pix = (size_t)(y0 + p / kTile) * wp + (x0 + p % kTile);
    float* out = image + pix * n_ch;
    out[0] = acc[i][0];
    out[1] = acc[i][1];
    out[2] = acc[i][2];
    if (n_ch > 3) out[3] = acc[i][3];
    alpha[pix] = 1.0f - T[i];
    if constexpr (kTrain) {
      t_final[pix] = T[i];
      last[pix] = last_k[i];
    }
  }
}

}  // namespace

extern "C" int lfs_blend_forward(const void* tile_start, const void* tile_count,
                                 const void* gaussian_idx, const void* mean2d,
                                 const void* conic, const void* opacity,
                                 const void* color, int n_ch, int grid_w,
                                 int grid_h, int tile_size, float threshold,
                                 void* image, void* alpha, void* t_final,
                                 void* last, void* stream) {
  const int n_tiles = grid_w * grid_h;
  const bool train = last != nullptr;
  if ((tile_size != 16 && tile_size != 32) || (t_final != nullptr) != train)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tile_size == 16
      ? (train ? blend_forward_kernel<16, true> : blend_forward_kernel<16, false>)
      : (train ? blend_forward_kernel<32, true> : blend_forward_kernel<32, false>);
  kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(gaussian_idx), static_cast<const float*>(mean2d),
      static_cast<const float*>(conic), static_cast<const float*>(opacity),
      static_cast<const float*>(color), n_ch, grid_w, threshold,
      static_cast<float*>(image), static_cast<float*>(alpha),
      static_cast<float*>(t_final), static_cast<int*>(last));
  return static_cast<int>(cudaGetLastError());
}
