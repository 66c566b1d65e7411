// Kernel T3: which way to lay the depth axis of a blend, across the lanes
// of a warp or serially inside the thread that owns a pixel.
//
// Replaces the TPU kernel tools/microbench_scan_orient.py::_kernel (entry
// run, the pl.pallas_call). The recurrence, `reps` times over a 128-deep
// axis: p = prefix product of 1 - 1e-4 x, s = prefix sum of x * p, an
// accumulator takes the last row of p (or of s), and x = 0.9999 x + 1e-7 s.
// The original asked which axis of a [128, 1024] block a v5e scans more
// cheaply; the card's question is how P2, P3, P5 and P6 should walk a
// tile's depth:
//
//   * "lanes" (the original's axis 1 on [1024, 128]): a warp owns a pixel,
//     the 128 depth values lie 4 a lane across its lanes, and both scans
//     are log-step shuffle scans (microbench_common.cuh::warp_scan128).
//     Out [1, 128]: the sums s of the slab's last pixel, as the original's
//     s[-1:];
//   * "thread" (the original's axis 0 on [128, 1024]): a thread owns a
//     pixel and walks the depth serially with a running product and sum,
//     the way the blend kernels walk a tile today; the pixel's x column
//     lives in shared memory (conflict-free: consecutive threads,
//     consecutive words). Out [1, 1024]: each pixel's total product, as the
//     original's p[-1:].
//
// Both also write the final x, so that every pixel's work is observable.
// The lanes form does 7 levels where the serial form does one pass, about
// 2.5 times the arithmetic, but no step waits for the one before it.
// Bound: operations (8 a depth value and rep in the serial form) at the
// 67 TFLOP/s of float32 outside the tensor cores; none is an FMA.

#include "microbench_common.cuh"

namespace {

constexpr int kDepth = lfs_mb::kDepth;
constexpr int kLaneThreads = 1024;  // 32 warps: 32 pixels a block
constexpr int kPixelThreads = 128;  // 128 pixels a block, 64 KB of columns

__device__ __forceinline__ float decay_term(float x) {
  return __fsub_rn(1.0f, __fmul_rn(1e-4f, x));
}

__device__ __forceinline__ float next_x(float x, float s) {
  return __fadd_rn(__fmul_rn(x, 0.9999f), __fmul_rn(1e-7f, s));
}

// x, x_out: [n_pixels, 128]; out: [n_pixels / pixels_per_slab, 128]
__global__ void __launch_bounds__(kLaneThreads)
    scan_orient_lanes_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                             float4* __restrict__ x_out, int n_pixels, int pixels_per_slab,
                             int reps) {
  const int lane = threadIdx.x & 31;
  const int pixel = blockIdx.x * (kLaneThreads / 32) + (threadIdx.x >> 5);
  if (pixel >= n_pixels) return;  // warp-uniform
  const float4 a = x[(size_t)pixel * 32 + lane];
  float v[4] = {a.x, a.y, a.z, a.w};
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int r = 0; r < reps; ++r) {
    float p[4], s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = decay_term(v[j]);
    lfs_mb::warp_scan128<lfs_mb::MulF32>(p, 1.0f, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = __fmul_rn(v[j], p[j]);
    lfs_mb::warp_scan128<lfs_mb::AddF32>(s, 0.0f, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j] = __fadd_rn(acc[j], s[j]);
      v[j] = next_x(v[j], s[j]);
    }
  }
  x_out[(size_t)pixel * 32 + lane] = make_float4(v[0], v[1], v[2], v[3]);
  if (pixel % pixels_per_slab == pixels_per_slab - 1)
    out[(size_t)(pixel / pixels_per_slab) * 32 + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// x, x_out: [n_slabs, 128, width]; out: [n_slabs, width]; width % 128 == 0
__global__ void __launch_bounds__(kPixelThreads)
    scan_orient_thread_kernel(const float* __restrict__ x, float* __restrict__ out,
                              float* __restrict__ x_out, int width, int reps) {
  extern __shared__ float col[];  // [128 depth][128 pixels]
  const int blocks_per_slab = width / kPixelThreads;
  const int slab = blockIdx.x / blocks_per_slab;
  const int c = (blockIdx.x % blocks_per_slab) * kPixelThreads + threadIdx.x;
  const size_t base = (size_t)slab * kDepth * width + c;
  const int t = threadIdx.x;
  for (int i = 0; i < kDepth; ++i) col[i * kPixelThreads + t] = x[base + (size_t)i * width];
  float acc = 0.0f;
  for (int r = 0; r < reps; ++r) {
    float p = 1.0f, s = 0.0f;
    for (int i = 0; i < kDepth; ++i) {
      const float xv = col[i * kPixelThreads + t];
      p = __fmul_rn(p, decay_term(xv));
      s = __fadd_rn(s, __fmul_rn(xv, p));
      col[i * kPixelThreads + t] = next_x(xv, s);
    }
    acc = __fadd_rn(acc, p);
  }
  for (int i = 0; i < kDepth; ++i) x_out[base + (size_t)i * width] = col[i * kPixelThreads + t];
  out[(size_t)slab * width + c] = acc;
}

}  // namespace

extern "C" int lfs_mb_scan_orient_lanes(const void* x, void* out, void* x_out, int n_slabs,
                                        int pixels_per_slab, int reps, void* stream) {
  if (n_slabs < 1 || pixels_per_slab < 1 || reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_pixels = n_slabs * pixels_per_slab;
  const int per_block = kLaneThreads / 32;
  scan_orient_lanes_kernel<<<(n_pixels + per_block - 1) / per_block, kLaneThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), static_cast<float4*>(x_out),
      n_pixels, pixels_per_slab, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lfs_mb_scan_orient_thread(const void* x, void* out, void* x_out, int n_slabs,
                                         int width, int reps, void* stream) {
  if (n_slabs < 1 || width < kPixelThreads || width % kPixelThreads != 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = kDepth * kPixelThreads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scan_orient_thread_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_orient_thread_kernel<<<n_slabs * (width / kPixelThreads), kPixelThreads, kSmem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<float*>(x_out), width,
      reps);
  return static_cast<int>(cudaGetLastError());
}
