// Kernel T2: what a block pays to stream chunks from device memory into a
// ring in shared memory, as strided row segments or as one contiguous
// piece.
//
// Replaces the TPU kernel tools/microbench_dma_stream.py::_stream_kernel
// (entry run, the pl.pallas_call): `nb` chunks [rows, width] of an f32
// [rows, nb * width] array go through a 4-slot ring of asynchronous copies;
// element [0, 0] of each chunk is read and summed. A chunk is `rows`
// segments of 4 * width bytes, row_stride apart: [8, 128] is eight
// 512-byte segments, [1, 1024] the same 4 KB in one piece. That is the
// choice the 2D and world blends face for their batch loads (feature-major
// rows against instance-major blocks).
//
// On the card the asynchronous copy is cp.async (16 bytes a thread,
// cp.async.cg: through L2, past L1), one commit group a chunk, and
// cp.async.wait_group keeps 3 chunks in flight while the fourth is read.
// One __syncthreads a chunk: it makes every thread's copies of this chunk
// visible, and it orders the reads of the chunk before against the copy
// that overwrites its slot. A block owns a contiguous range of chunks and
// writes one partial sum: a grid of 1 is the original's single core, a
// grid that fills the SMs asks what the card's memory gives. (TMA would
// start a chunk from one thread; that is a later tool.)
//
// Bound: bytes (every chunk read once) at 3.35 TB/s; the arithmetic is one
// add a chunk.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;

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

__global__ void __launch_bounds__(kThreads)
    stream_ring_kernel(const float* __restrict__ x,  // [rows, nb * width]
                       int rows, int width, int nb, int chunks_per_block,
                       float* __restrict__ out) {    // [gridDim.x]
  extern __shared__ float4 ring[];  // [kSlots][rows * width / 4]
  const int vec_per_row = width / 4;
  const int vec_per_chunk = rows * vec_per_row;
  const size_t row_stride = (size_t)nb * width;
  const int c0 = blockIdx.x * chunks_per_block;
  const int c1 = min(nb, c0 + chunks_per_block);

  auto start_copy = [&](int ci) {
    float4* slot = ring + (size_t)((ci - c0) % kSlots) * vec_per_chunk;
    for (int v = threadIdx.x; v < vec_per_chunk; v += kThreads) {
      const int r = v / vec_per_row, q = v - r * vec_per_row;
      cp_async16(slot + v, x + (size_t)r * row_stride + (size_t)ci * width + 4 * q);
    }
  };

  // every thread commits one group a chunk, whether or not it started a
  // copy, so that the group counts agree across the block
  for (int k = 0; k < kSlots - 1; ++k) {
    if (c0 + k < c1) start_copy(c0 + k);
    cp_async_commit();
  }
  float acc = 0.0f;
  for (int ci = c0; ci < c1; ++ci) {
    cp_async_wait<kSlots - 2>();  // this chunk's group has landed
    __syncthreads();
    if (ci + kSlots - 1 < c1) start_copy(ci + kSlots - 1);  // into the slot read a chunk ago
    cp_async_commit();
    if (threadIdx.x == 0)
      acc += reinterpret_cast<const float*>(ring + (size_t)((ci - c0) % kSlots) * vec_per_chunk)[0];
  }
  cp_async_wait<0>();
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace

// x: [rows, nb * width] f32, width % 4 == 0, 16-byte aligned rows;
// out: [n_blocks] f32, block b sums chunks [b * per, min(nb, (b + 1) * per)),
// per = ceil(nb / n_blocks).
extern "C" int lfs_mb_stream_ring(const void* x, int rows, int width, int nb, int n_blocks,
                                  void* out, void* stream) {
  if (rows < 1 || width < 4 || width % 4 != 0 || nb < 1 || n_blocks < 1 || n_blocks > nb)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)kSlots * rows * width * sizeof(float);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(stream_ring_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = (nb + n_blocks - 1) / n_blocks;
  stream_ring_kernel<<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, width, nb, per, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
