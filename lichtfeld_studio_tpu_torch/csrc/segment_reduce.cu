// Kernel P4: per-gaussian sums of contiguous slot segments.
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/segment_reduce.py
// (_segment_reduce_kernel, entry _segment_reduce_call <-
// grad_segment_reduce_packed / segment_reduce_cols): out[n, :] =
// sum over s in [off[n], off[n+1]) of rows[s, :], with off the exclusive
// cumsum of n_touched clipped to the instance cap, so instances dropped by
// an overflow contribute nothing (segment_reduce.py:216-223). The TPU
// kernel built a {0,1} interval-membership matrix per 1024-gaussian block
// and contracted it with the rows on the MXU (no gather or scatter on the
// TPU), compared slot ids as f32 (exact only below 2^24) and unpacked bf16
// colour pairs. Here:
//
//   * one warp per gaussian: the lanes stride its segment, each summing F
//     floats in registers, then __shfl_xor_sync reduces the warp in a fixed
//     order (deterministic, no atomics); lane f writes column f;
//   * offsets and slots are int32 throughout; rows are f32 (P3 and P6 write
//     f32 colours, so there are no pairs to unpack);
//   * the column count is a template parameter, 16 or 32: the 2D path's
//     9 or 10 columns (P3) take the 16-wide instance, the world blend's 24
//     or 32 (P6) the 32-wide one, so the 2D path keeps its registers.
//
// Segments are short (the exact tile test gives a gaussian at most 32
// tiles at 16 px, 16 at 32 px; only conservative-bbox gaussians have
// more), so most lanes of a warp idle on a 1-3 row segment. Bound on the
// H100: device-memory traffic, 4 F bytes per slot read and per gaussian
// written (~100 MB at a 1.4M cap and 1M gaussians, ~30 us at 3.35 TB/s);
// with most lanes idle the kernel is latency-bound at a few times that.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxColumns = 32;

template <int kMaxF>
__global__ void __launch_bounds__(kThreads)
    segment_reduce_kernel(const float* __restrict__ rows,  // [cap, n_f]
                          const int* __restrict__ off,     // [n + 1], clipped to cap
                          int n, int n_f,
                          float* __restrict__ out) {       // [n, n_f]
  const int seg = static_cast<int>((blockIdx.x * (size_t)kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= n) return;  // warp-uniform: a warp serves one segment
  const int s0 = off[seg];
  const int s1 = off[seg + 1];
  float acc[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) acc[f] = 0.0f;
  for (int s = s0 + lane; s < s1; s += 32) {
    const float* r = rows + (size_t)s * n_f;
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      if (f < n_f) acc[f] += r[f];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      if (f < n_f) acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], o);
  }
#pragma unroll
  for (int f = 0; f < kMaxF; ++f)
    if (f < n_f && lane == f) out[(size_t)seg * n_f + f] = acc[f];
}

}  // namespace

extern "C" int lfs_segment_reduce(const void* rows, const void* off, int n, int n_f,
                                  void* out, void* stream) {
  if (n_f < 1 || n_f > kMaxColumns) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const size_t threads = (size_t)n * 32;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  auto kernel = n_f <= 16 ? segment_reduce_kernel<16> : segment_reduce_kernel<kMaxColumns>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(off), n, n_f,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
