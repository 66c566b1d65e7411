// Kernel P1: instance expansion, slot -> (owning gaussian, rank, payload).
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/expand_pallas.py
// (_expand_kernel, entry expand_instances). That kernel needed a compaction
// sort and a windowed one-hot matmul on the MXU because a TPU core cannot
// gather per lane; a GPU thread can. Here, as in upstream fastgs
// duplicateWithKeys (forward.cu:103-147), each thread owns one slot s and
// binary-searches the INCLUSIVE cumsum `ends` of n_touched for the first
// gaussian g with ends[g] > s: its segment [ends[g-1], ends[g]) holds s.
// Culled gaussians (n_touched == 0) have empty segments and are stepped
// over, so in a run of gaussians that share one offset the search lands on
// the last of them, the live one: exactly what the scatter-marker + cumsum
// construction of ops/tiles.py gives. Slots past the total get g = C-1 and
// rank = s - offset >= n_touched[g], in bounds and invalid.
//
// Bound on the H100: memory. Per slot it writes 6 int32 (24 B) and reads
// ~log2(C) = 20 entries of `ends` (2.6 MB at 660k gaussians, so the search
// runs out of the 50 MB L2) plus the 4 payload words of g, which neighbouring
// slots share. Threads of a warp take neighbouring slots, so the stores are
// coalesced; the payload reads hit the same few gaussians and coalesce too.
// No shared memory, no synchronisation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void expand_kernel(const int* __restrict__ ends,
                              const int* __restrict__ payload_t,  // [4, C]
                              int n_gauss, int cap,
                              int* __restrict__ g_out,     // [cap]
                              int* __restrict__ rank_out,  // [cap]
                              int* __restrict__ pl_out) {  // [4, cap]
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  // upper bound: first g with ends[g] > s
  int lo = 0, hi = n_gauss;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) <= s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int g = lo < n_gauss ? lo : n_gauss - 1;
  const int off = g > 0 ? __ldg(ends + g - 1) : 0;
  g_out[s] = g;
  rank_out[s] = s - off;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    pl_out[(size_t)w * cap + s] = __ldg(payload_t + (size_t)w * n_gauss + g);
  }
}

}  // namespace

extern "C" int lfs_expand_instances(const void* ends, const void* payload_t,
                                    int n_gauss, int cap, void* g, void* rank,
                                    void* pl_t, void* stream) {
  const int blocks = (cap + kThreads - 1) / kThreads;
  expand_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ends), static_cast<const int*>(payload_t), n_gauss,
      cap, static_cast<int*>(g), static_cast<int*>(rank),
      static_cast<int*>(pl_t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lfs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
