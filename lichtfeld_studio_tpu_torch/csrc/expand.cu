// Kernel P1: instance expansion, slot -> (owning gaussian, rank, payload).
//
// Replaces the TPU kernel lichtfeld_studio_tpu/kernels/expand_pallas.py
// (_expand_kernel, entry expand_instances). That kernel needed a compaction
// sort and a windowed one-hot matmul on the MXU because a TPU core cannot
// gather per lane; a GPU thread can.
//
// What it computes (unchanged by the redesign for the H100): slot s belongs
// to the first gaussian g with ends[g] > s, where `ends` is the INCLUSIVE
// cumsum of n_touched: its segment [ends[g-1], ends[g]) holds s. Culled
// gaussians (n_touched == 0) have empty segments and are stepped over, so
// in a run of gaussians that share one offset the slot goes to the last of
// them, the live one: exactly what the scatter-marker + cumsum construction
// of ops/tiles.py gives. Slots past the total get g = C-1 and
// rank = s - offset >= n_touched[g], in bounds and invalid.
// pl[:, s] = payload_t[:, g].
//
// What bounds it on the H100, and the design. The bound is bytes: each
// slot writes 6 int32 (24 B, 50 MB at cap 2^21), and `ends` and the
// payload are read once (13 MB at 660k gaussians). The first port gave each
// slot its own binary search of ~20 DEPENDENT loads into `ends`, so it was
// bound by the latency of that chain, not by bytes. Here the owner is
// found by merging: the slots 0..cap-1 and `ends` are two sorted sequences,
// and the owner of slot s is the number of ends at or below s, that is,
// how many ends precede s in their merge (an end at or below the slot goes
// first). So (merge path):
//
//   * the merge of the two sequences, C + cap items, is cut into equal
//     pieces of kPiece items, one a block. Two warps find the block's two
//     cuts, each by a 32-ary search along its diagonal (a lane a probe, one
//     ballot a round: 4 dependent loads for a million gaussians, not 20).
//     A piece holds kPiece items whatever the data: a run of culled
//     gaussians longer than any window of slots only spreads over more
//     pieces (a window of `ends` sized by the slots alone would not bound
//     it);
//   * the block stages its slice of `ends` (and the two before it, for
//     the offsets) in shared memory;
//   * each thread searches its own diagonal of the piece in shared memory
//     and walks its kItems merge steps serially, writing each slot's owner
//     into shared memory;
//   * then the block writes its slots' owner, rank and payload words with
//     consecutive threads on consecutive slots: coalesced stores; the
//     payload reads of neighbouring slots fall on the same few gaussians;
//   * what is left is latency (the cuts' searches, the staging, the
//     payload reads), so the pieces are small (4 merge steps a thread,
//     1,024 items a block) and registers are capped for eight blocks an
//     SM, 64 warps: the most an SM holds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                   // merge steps a thread
constexpr int kPiece = kThreads * kItems;   // merge items a block: ends and slots together
constexpr int kBlocksPerSm = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// How many of ends[0..n) lie among the first d items of the merge: end i
// sits at merge position i + min(ends[i], cap) (the slots below it go
// first), which grows with i. A warp's 32-ary search: each round lane l
// probes one point of the range, one ballot narrows it 33-fold.
__device__ __forceinline__ int merge_split(const int* __restrict__ ends, int n, int cap,
                                           long long d, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (true) {
    const int span = hi - lo;
    const bool each = span <= 32;  // the last round probes every point
    const int p = each ? lo + lane : lo + static_cast<int>((static_cast<long long>(span) * (lane + 1)) / 33);
    const bool before = p < hi && static_cast<long long>(p) + min(__ldg(ends + p), cap) < d;
    const int k = __popc(__ballot_sync(kFullMask, before));  // a prefix of the lanes
    if (each) return lo + k;
    const int p_last = __shfl_sync(kFullMask, p, k > 0 ? k - 1 : 0);
    const int p_next = __shfl_sync(kFullMask, p, k < 32 ? k : 31);
    if (k > 0) lo = p_last + 1;
    if (k < 32) hi = p_next;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    expand_kernel(const int* __restrict__ ends,
                  const int* __restrict__ payload_t,  // [4, C]
                  int n_gauss, int cap,
                  int* __restrict__ g_out,     // [cap]
                  int* __restrict__ rank_out,  // [cap]
                  int* __restrict__ pl_out) {  // [4, cap]
  __shared__ int s_end[kPiece + 2];  // ends[i0 - 2 .. i1)
  __shared__ int s_owner[kPiece];    // per slot of the piece: the ends at or below it
  __shared__ int s_cut[2];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long total = static_cast<long long>(n_gauss) + cap;
  const long long d0 = static_cast<long long>(blockIdx.x) * kPiece;
  const long long d1 = min(d0 + kPiece, total);
  if (warp < 2) {
    const int i = merge_split(ends, n_gauss, cap, warp == 0 ? d0 : d1, lane);
    if (lane == 0) s_cut[warp] = i;
  }
  __syncthreads();
  const int i0 = s_cut[0], i1 = s_cut[1];
  const int j0 = static_cast<int>(d0 - i0);  // the piece's first slot
  const int na = i1 - i0;                    // its ends
  const int nb = static_cast<int>(d1 - i1) - j0;  // its slots
  for (int k = threadIdx.x; k < na + 2; k += kThreads) {
    const int i = i0 - 2 + k;
    s_end[k] = i >= 0 ? __ldg(ends + i) : 0;
  }
  __syncthreads();
  const int* a = s_end + 2;  // a[i] = ends[i0 + i], from i = -2

  // this thread's diagonal: how many of the piece's ends come before its
  // first item (end i sits at i + the piece's slots below it)
  const int dt = min(static_cast<int>(threadIdx.x) * kItems, na + nb);
  int lo = max(0, dt - nb), hi = min(dt, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (mid + min(max(a[mid] - j0, 0), nb) < dt) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  // kItems merge steps: an end at or below the slot goes first (ends past
  // the last slot come after every slot)
  int i = lo, j = dt - lo;
  const int stop = min(dt + kItems, na + nb);
  for (int t = dt; t < stop; ++t) {
    if (i < na && (j >= nb || a[i] <= j0 + j)) {
      ++i;
    } else {
      s_owner[j] = i0 + i;
      ++j;
    }
  }
  __syncthreads();

  for (int jj = threadIdx.x; jj < nb; jj += kThreads) {
    const int s = j0 + jj;
    const int g = min(s_owner[jj], n_gauss - 1);
    g_out[s] = g;
    rank_out[s] = s - (g > 0 ? a[g - 1 - i0] : 0);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      pl_out[(size_t)w * cap + s] = __ldg(payload_t + (size_t)w * n_gauss + g);
    }
  }
}

}  // namespace

extern "C" int lfs_expand_instances(const void* ends, const void* payload_t,
                                    int n_gauss, int cap, void* g, void* rank,
                                    void* pl_t, void* stream) {
  if (n_gauss < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(n_gauss) + cap;
  const int blocks = static_cast<int>((items + kPiece - 1) / kPiece);
  expand_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ends), static_cast<const int*>(payload_t), n_gauss,
      cap, static_cast<int*>(g), static_cast<int*>(rank),
      static_cast<int*>(pl_t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lfs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
