// Shared pieces of the microbenchmark kernels (microbench_alu.cu,
// microbench_scan.cu): the value types (float, and two bf16 values packed
// in a __nv_bfloat162) with their arithmetic, and the log-step inclusive
// scan over a 128-deep axis held as 4 contiguous values a lane across the
// 32 lanes of a warp.
//
// Every operation is the round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __hmul2_rn, __hadd2_rn): nothing is contracted into an FMA, so a kernel
// rounds where its plain PyTorch version (kernels/microbench.py) rounds
// and float32 results agree to the bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lfs_mb {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kDepth = 128;  // the scanned axis: 4 values a lane x 32 lanes

struct MulF32 {
  __device__ __forceinline__ static float apply(float a, float b) { return __fmul_rn(a, b); }
};
struct AddF32 {
  __device__ __forceinline__ static float apply(float a, float b) { return __fadd_rn(a, b); }
};
struct MulBf162 {
  __device__ __forceinline__ static __nv_bfloat162 apply(__nv_bfloat162 a, __nv_bfloat162 b) {
    return __hmul2_rn(a, b);
  }
};

// Hillis-Steele inclusive scan of 128 values, element i = 4 * lane + j in
// v[j]: x[i] = op(x[i], x[i - shift]) for shift = 1, 2, 4, ..., 64, with
// `pad` where i < shift. The same tree, level by level, as the plain
// version's shift-and-pad scan. Shifts 1 and 2 stay partly inside the lane;
// from 4 on a shift is a whole number of lanes, one __shfl_up_sync a value.
template <class Op, class T>
__device__ __forceinline__ void warp_scan128(T v[4], T pad, int lane) {
  {  // shift 1
    T up = __shfl_up_sync(kFullMask, v[3], 1);
    if (lane == 0) up = pad;
    const T n0 = Op::apply(v[0], up), n1 = Op::apply(v[1], v[0]);
    const T n2 = Op::apply(v[2], v[1]), n3 = Op::apply(v[3], v[2]);
    v[0] = n0; v[1] = n1; v[2] = n2; v[3] = n3;
  }
  {  // shift 2
    T up2 = __shfl_up_sync(kFullMask, v[2], 1);
    T up3 = __shfl_up_sync(kFullMask, v[3], 1);
    if (lane == 0) { up2 = pad; up3 = pad; }
    const T n0 = Op::apply(v[0], up2), n1 = Op::apply(v[1], up3);
    const T n2 = Op::apply(v[2], v[0]), n3 = Op::apply(v[3], v[1]);
    v[0] = n0; v[1] = n1; v[2] = n2; v[3] = n3;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {  // shifts 4, 8, 16, 32, 64
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T up = __shfl_up_sync(kFullMask, v[j], d);
      if (lane < d) up = pad;
      v[j] = Op::apply(v[j], up);
    }
  }
}

}  // namespace lfs_mb
