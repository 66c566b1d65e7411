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
// colour pairs. Here offsets and slots are int32 and rows are f32 (P3 and
// P6 write f32 colours, so there are no pairs to unpack).
//
// What bounds it on the H100: device-memory traffic alone, 4 F bytes per
// used slot read and per gaussian written plus the offsets (~85 MB at 1.25M
// slots, 1M gaussians and F = 9: ~25 us at 3.35 TB/s); one add per value.
// Segments are 1-3 rows (the exact tile test gives a gaussian at most 32
// tiles at 16 px, 16 at 32 px; only conservative-bbox gaussians have more)
// and a third of the capacity is dead slots with empty segments, so the
// design is about moving whole lines and wasting no lane:
//
//   * the rows are in slot order, so the rows of a contiguous range of
//     gaussians are ONE contiguous range of memory, and so are their sums.
//     A block owns kThreads consecutive gaussians. There is no gather;
//   * it reads their kThreads + 1 offsets into shared memory, then streams
//     rows[off[g0] : off[g1]] through a two-slot ring in shared memory in
//     chunks of whole rows with 16-byte cp.async copies (the window is
//     widened down to a 16-byte boundary; the array's last, partial vector
//     is copied by scalars). The loop takes any number of chunks;
//   * per chunk, one thread per (gaussian, column) adds its segment's part
//     of the chunk from shared memory serially in slot order (float32, the
//     order of a plain loop; deterministic, no atomics) and writes the sum:
//     consecutive threads write consecutive floats. The gaussians a chunk
//     completes are found with one __syncthreads_count of "my segment ends
//     in this chunk" (the offsets ascend), which is also the barrier that
//     publishes the chunk. The one segment that straddles the chunk's end
//     leaves its partial in shared memory for the next chunk, however many
//     chunks it spans;
//   * empty segments (dead slots, culled gaussians, everything past the
//     cap) cost one compare and write 0; a block whose range is all empty
//     only writes zeros;
//   * the column count is a template parameter for the widths the blends
//     write (9 and 10: P3; 24 and 32: P6), so the (gaussian, column) split
//     divides by a constant; any other width in 1..32 takes the run-time
//     instance.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;  // also the gaussians a block owns
constexpr int kMaxColumns = 32;
constexpr int kSlots = 2;
constexpr int kChunkFloats = 4096;  // a ring slot: 16 KB of whole rows

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <int kNF>  // kNF = 0: the column count at run time
__global__ void __launch_bounds__(kThreads)
    segment_reduce_kernel(const float* __restrict__ rows,  // [n_rows, n_f], 16-byte aligned
                          const int* __restrict__ off,     // [n + 1], ascending, <= n_rows
                          int n, int n_f_arg, int n_rows,
                          int chunk_rows,   // rows a ring slot holds
                          int slot_floats,  // its size: chunk_rows * n_f + 3, rounded up to 4
                          float* __restrict__ out) {  // [n, n_f]
  const int n_f = kNF > 0 ? kNF : n_f_arg;
  extern __shared__ float4 s_ring4[];
  float* s_ring = reinterpret_cast<float*>(s_ring4);  // [kSlots][slot_floats]
  __shared__ int s_off[kThreads + 1];
  __shared__ float s_carry[2][kMaxColumns];  // the straddling segment's partial

  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * kThreads;
  const int n_g = min(kThreads, n - g0);
  if (tid < n_g) s_off[tid] = off[g0 + tid];
  if (tid == 0) s_off[n_g] = off[g0 + n_g];
  __syncthreads();
  const int r0 = s_off[0], r1 = s_off[n_g];
  float* o = out + (size_t)g0 * n_f;
  if (r0 == r1) {  // every segment empty
    for (int i = tid; i < n_g * n_f; i += kThreads) o[i] = 0.0f;
    return;
  }
  const int my_end = tid < n_g ? s_off[tid + 1] : INT_MAX;
  const size_t total = (size_t)n_rows * n_f;
  const int n_chunks = (r1 - r0 + chunk_rows - 1) / chunk_rows;

  auto prefetch = [&](int k) {
    const int c0 = r0 + k * chunk_rows;
    const int c1 = min(c0 + chunk_rows, r1);
    const size_t begin = ((size_t)c0 * n_f) & ~(size_t)3;
    const size_t end = (size_t)c1 * n_f;
    float* dst = s_ring + (k % kSlots) * slot_floats;
    for (size_t src = begin + 4 * tid; src < end; src += 4 * kThreads) {
      if (src + 4 <= total) {
        cp_async16(dst + (src - begin), rows + src);
      } else {
        for (int q = 0; src + q < total; ++q) dst[src - begin + q] = rows[src + q];
      }
    }
  };

  prefetch(0);
  cp_async_commit();
  int first = 0;  // the first gaussian not yet complete
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) prefetch(k + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of chunk k have landed
    const int c0 = r0 + k * chunk_rows;
    const int c1 = min(c0 + chunk_rows, r1);
    // gaussians whose segment ends at or before c1; the barrier publishes chunk k
    const int next = __syncthreads_count(my_end <= c1);
    const bool straddles = next < n_g && s_off[next] < c1;
    const int n_items = (next - first + (straddles ? 1 : 0)) * n_f;
    const float* chunk = s_ring + (k % kSlots) * slot_floats +
                         static_cast<int>(((size_t)c0 * n_f) & 3);
    const float* carry_in = s_carry[k & 1];
    float* carry_out = s_carry[(k + 1) & 1];
    for (int i = tid; i < n_items; i += kThreads) {
      const int g = first + i / n_f;
      const int f = i % n_f;
      const int o0 = s_off[g], o1 = s_off[g + 1];
      float acc = o0 < c0 ? carry_in[f] : 0.0f;  // begun in an earlier chunk
      const int lo = max(o0, c0), hi = min(o1, c1);
      const float* p = chunk + (lo - c0) * n_f + f;
      for (int s = lo; s < hi; ++s, p += n_f) acc += *p;
      if (o1 <= c1) {
        o[g * n_f + f] = acc;
      } else {
        carry_out[f] = acc;
      }
    }
    first = next;
    __syncthreads();  // chunk k is read: its slot and carry_in may be rewritten
  }
}

template <int kNF>
int launch_segment_reduce(const float* rows, const int* off, int n, int n_f, int n_rows,
                          float* out, cudaStream_t stream) {
  const int chunk_rows = kChunkFloats / n_f;
  const int slot_floats = (chunk_rows * n_f + 3 + 3) & ~3;  // + the window's head, rounded
  const size_t smem = (size_t)kSlots * slot_floats * sizeof(float);  // < 48 KB
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  segment_reduce_kernel<kNF><<<blocks, kThreads, smem, stream>>>(
      rows, off, n, n_f, n_rows, chunk_rows, slot_floats, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lfs_segment_reduce(const void* rows, const void* off, int n, int n_f,
                                  int n_rows, void* out, void* stream) {
  if (n_f < 1 || n_f > kMaxColumns) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto launch = n_f == 9    ? launch_segment_reduce<9>
                : n_f == 10 ? launch_segment_reduce<10>
                : n_f == 24 ? launch_segment_reduce<24>
                : n_f == 32 ? launch_segment_reduce<32>
                            : launch_segment_reduce<0>;
  return launch(static_cast<const float*>(rows), static_cast<const int*>(off), n, n_f, n_rows,
                static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}
