// Kernels T1a and T1b: elementwise and prefix-scan throughput, float32
// against packed bf16, on the CUDA cores (T1b below).
//
// T1a replaces the TPU kernel tools/microbench_bf16_vpu.py::_elemwise_kernel
// (entry run, the pl.pallas_call): x [128, 1024] f32 is cast to the working
// type, `reps` times put through four dependent operations, each rounded in
// that type (acc * c, acc + acc, acc * 0.5, max(acc, 0)), and written back
// as f32. On the TPU one program is the whole chip and its grid of 64 runs
// in turn on the same block. Here a launch must fill 132 SMs or it measures
// occupancy, so every block has its own [128, 1024] slab of a
// [G, 128, 1024] input: G = 64 is the original's grid (half the card), a
// multiple of 132 fills it.
//
//   * float32: scalar __fmul_rn / __fadd_rn / fmaxf, 8 independent chains a
//     thread;
//   * bf16: pairs in __nv_bfloat162, __hmul2_rn / __hadd2_rn / __hmax2: one
//     instruction works on two values, 4 independent chains a thread on
//     the same 8 values.
//
// No operation is an FMA (acc * c followed by acc + acc must not contract,
// or the result leaves its plain version's in the last bit). Bound on the
// H100: operations. 4 * reps operations a value against 8 bytes moved
// puts the kernel far above the memory line: the data sheet's 67 TFLOP/s
// for float32 and 133.8 TFLOP/s for packed bf16 outside the tensor cores
// (NVIDIA H100 white paper, SXM5), both counted with an FMA as two
// operations, which these single operations reach at most half of.

#include "microbench_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSlab = 128 * 1024;      // floats in a block's slab
constexpr int kSlabVec = kSlab / 4;    // float4s in it

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    alu_kernel(const float4* __restrict__ x, float4* __restrict__ out, int reps, float c) {
  const float4* xs = x + (size_t)blockIdx.x * kSlabVec;
  float4* os = out + (size_t)blockIdx.x * kSlabVec;
  for (int v = threadIdx.x; v < kSlabVec / 2; v += kThreads) {
    const float4 a = xs[v];
    const float4 b = xs[v + kSlabVec / 2];
    if constexpr (kBf16) {
      __nv_bfloat162 acc[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                               __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
      const __nv_bfloat162 cc = __float2bfloat162_rn(c);
      const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
      const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[k] = __hmul2_rn(acc[k], cc);
          acc[k] = __hadd2_rn(acc[k], acc[k]);
          acc[k] = __hmul2_rn(acc[k], half);
          acc[k] = __hmax2(acc[k], zero);
        }
      }
      const float2 f0 = __bfloat1622float2(acc[0]), f1 = __bfloat1622float2(acc[1]);
      const float2 f2 = __bfloat1622float2(acc[2]), f3 = __bfloat1622float2(acc[3]);
      os[v] = make_float4(f0.x, f0.y, f1.x, f1.y);
      os[v + kSlabVec / 2] = make_float4(f2.x, f2.y, f3.x, f3.y);
    } else {
      float acc[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          acc[k] = __fmul_rn(acc[k], c);
          acc[k] = __fadd_rn(acc[k], acc[k]);
          acc[k] = __fmul_rn(acc[k], 0.5f);
          acc[k] = fmaxf(acc[k], 0.0f);
        }
      }
      os[v] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      os[v + kSlabVec / 2] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
}


// ---------------------------------------------------------------------------
// Kernel T1b: the log-step inclusive prefix PRODUCT along the 128-deep axis
// of a [128, 1024] slab, `reps` times, each followed by * decay.
//
// Replaces tools/microbench_bf16_vpu.py::_scan_kernel (entry run). The TPU
// original compared two ways to shift along the scanned axis (pad + slice
// against roll + select); the card's two ways are
//
//   * lane shuffles: a warp holds one column (bf16: a pair of columns in a
//     __nv_bfloat162), 4 contiguous values a lane, and shifts with
//     __shfl_up_sync (microbench_common.cuh::warp_scan128);
//   * shared memory: a thread holds one value, writes it to a double
//     buffer, and reads the value `shift` rows up after one __syncthreads a
//     level.
//
// Both walk the same tree, level by level, as the plain version, so float32
// agrees to the bit. One block of 1024 threads owns a slab. Bound:
// operations (7 * 128 + 128 multiplies a column and rep, no FMA among
// them), at the rates named above.

constexpr int kDepth = lfs_mb::kDepth;
constexpr int kWidth = 1024;

struct F32 {
  using T = float;
  using Mul = lfs_mb::MulF32;
  static constexpr int kCols = 1;
  __device__ __forceinline__ static T load(const float* p) { return *p; }
  __device__ __forceinline__ static void store(float* p, T v) { *p = v; }
  __device__ __forceinline__ static T splat(float f) { return f; }
};

struct Bf162 {
  using T = __nv_bfloat162;
  using Mul = lfs_mb::MulBf162;
  static constexpr int kCols = 2;
  __device__ __forceinline__ static T load(const float* p) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    return __floats2bfloat162_rn(f.x, f.y);
  }
  __device__ __forceinline__ static void store(float* p, T v) {
    *reinterpret_cast<float2*>(p) = __bfloat1622float2(v);
  }
  __device__ __forceinline__ static T splat(float f) { return __float2bfloat162_rn(f); }
};

template <class V>
__global__ void __launch_bounds__(kThreads)
    scan_prod_shfl_kernel(const float* __restrict__ x, float* __restrict__ out, int reps,
                          float decay) {
  using T = typename V::T;
  const size_t slab = (size_t)blockIdx.x * kDepth * kWidth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T one = V::splat(1.0f), k = V::splat(decay);
  for (int u = warp; u < kWidth / V::kCols; u += kThreads / 32) {
    const size_t base = slab + (size_t)(4 * lane) * kWidth + u * V::kCols;
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = V::load(x + base + (size_t)j * kWidth);
    for (int r = 0; r < reps; ++r) {
      lfs_mb::warp_scan128<typename V::Mul>(v, one, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = V::Mul::apply(v[j], k);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) V::store(out + base + (size_t)j * kWidth, v[j]);
  }
}

template <class V>
__global__ void __launch_bounds__(kThreads)
    scan_prod_smem_kernel(const float* __restrict__ x, float* __restrict__ out, int reps,
                          float decay) {
  using T = typename V::T;
  constexpr int kUnits = kThreads / kDepth;  // 8 columns (bf16: column pairs) at a time
  static_assert(sizeof(T) == sizeof(float), "a value fills one 32-bit word");
  __shared__ float raw[2 * kDepth * kUnits];
  T* buf = reinterpret_cast<T*>(raw);
  const size_t slab = (size_t)blockIdx.x * kDepth * kWidth;
  const int i = threadIdx.x / kUnits, cc = threadIdx.x % kUnits;
  const T one = V::splat(1.0f), k = V::splat(decay);
  int cur = 0;
  for (int grp = 0; grp < kWidth / (kUnits * V::kCols); ++grp) {
    const size_t at = slab + (size_t)i * kWidth + (grp * kUnits + cc) * V::kCols;
    T v = V::load(x + at);
    for (int r = 0; r < reps; ++r) {
      for (int s = 1; s < kDepth; s <<= 1) {
        // one sync a level: the buffer written now was last read a level
        // ago, before the sync that every thread has passed since
        buf[(cur * kDepth + i) * kUnits + cc] = v;
        __syncthreads();
        const T up = i >= s ? buf[(cur * kDepth + i - s) * kUnits + cc] : one;
        v = V::Mul::apply(v, up);
        cur ^= 1;
      }
      v = V::Mul::apply(v, k);
    }
    V::store(out + at, v);
  }
}

}  // namespace

// x, out: [n_slabs, 128, 1024] f32. bf16 != 0 selects the packed bf16 path.
extern "C" int lfs_mb_alu_elementwise(const void* x, void* out, int n_slabs, int reps, float c,
                                      int bf16, void* stream) {
  if (n_slabs < 1 || reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bf16 ? alu_kernel<true> : alu_kernel<false>;
  kernel<<<n_slabs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), reps, c);
  return static_cast<int>(cudaGetLastError());
}

// x, out: [n_slabs, 128, 1024] f32. smem != 0 selects the shared-memory
// shifts, else the lane shuffles.
extern "C" int lfs_mb_scan_prod(const void* x, void* out, int n_slabs, int reps, float decay,
                                int bf16, int smem, void* stream) {
  if (n_slabs < 1 || reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = smem ? (bf16 ? scan_prod_smem_kernel<Bf162> : scan_prod_smem_kernel<F32>)
                     : (bf16 ? scan_prod_shfl_kernel<Bf162> : scan_prod_shfl_kernel<F32>);
  kernel<<<n_slabs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), reps, decay);
  return static_cast<int>(cudaGetLastError());
}
