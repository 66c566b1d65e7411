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
// or the result leaves its plain version's in the last bit; acc + acc and
// acc * 0.5 are exact here, so a kernel that dropped them would still
// match). Bound on the H100: operations. 4 * reps operations a value
// against 8 bytes moved puts the kernel far above the memory line: the
// data sheet's 67 TFLOP/s for float32 and 133.8 TFLOP/s for packed bf16
// outside the tensor cores (NVIDIA H100 white paper, SXM5), both counted
// with an FMA as two operations, which these single operations reach at
// most half of: one instruction a lane and clock is the ceiling.
//
// The redesign for the H100 spends float32's issue slots on those four
// instructions and nothing else:
//
//   * in float32, `reps` is a template argument for the tool's two counts
//     (2, its check, and 64, its timing), so the repetitions unroll whole:
//     no counter, compare or branch among the float instructions. bf16,
//     which measured slower so (PERF.md), and any other count take the same
//     kernel with a run-time loop unrolled by 8;
//   * 1024 threads a block, one [128, 1024] slab a block, 8 independent
//     chains a thread (4 bf16 pairs): enough independent instructions for
//     the four dependent ones of each chain.

#include "microbench_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSlab = 128 * 1024;      // floats in a block's slab
constexpr int kSlabVec = kSlab / 4;    // float4s in it
constexpr int kHalfVec = kSlabVec / 2;  // a thread's two float4s a pass lie this far apart

// One repetition of the four rounded operations on a thread's 8 values
// (float32: 8 chains; bf16: 4 chains of packed pairs).
__device__ __forceinline__ void alu_step(float (&acc)[8], float c) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc[k] = __fmul_rn(acc[k], c);
    acc[k] = __fadd_rn(acc[k], acc[k]);
    acc[k] = __fmul_rn(acc[k], 0.5f);
    acc[k] = fmaxf(acc[k], 0.0f);
  }
}

__device__ __forceinline__ void alu_step(__nv_bfloat162 (&acc)[4], __nv_bfloat162 c) {
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[k] = __hmul2_rn(acc[k], c);
    acc[k] = __hadd2_rn(acc[k], acc[k]);
    acc[k] = __hmul2_rn(acc[k], half);
    acc[k] = __hmax2(acc[k], zero);
  }
}

// `reps` repetitions: kReps > 0 takes exactly kReps, unrolled whole; 0
// takes `reps`, in a loop unrolled by 8
template <int kReps, class T, int N>
__device__ __forceinline__ void alu_reps(T (&acc)[N], int reps, T c) {
  if constexpr (kReps > 0) {
#pragma unroll
    for (int r = 0; r < kReps; ++r) alu_step(acc, c);
  } else {
#pragma unroll 8
    for (int r = 0; r < reps; ++r) alu_step(acc, c);
  }
}

template <bool kBf16, int kReps>
__global__ void __launch_bounds__(kThreads)
    alu_kernel(const float4* __restrict__ x, float4* __restrict__ out, int reps, float c) {
  const float4* xs = x + (size_t)blockIdx.x * kSlabVec;
  float4* os = out + (size_t)blockIdx.x * kSlabVec;
  for (int v = threadIdx.x; v < kHalfVec; v += kThreads) {
    const float4 a = xs[v];
    const float4 b = xs[v + kHalfVec];
    if constexpr (kBf16) {
      __nv_bfloat162 acc[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                               __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
      alu_reps<kReps>(acc, reps, __float2bfloat162_rn(c));
      const float2 f0 = __bfloat1622float2(acc[0]), f1 = __bfloat1622float2(acc[1]);
      const float2 f2 = __bfloat1622float2(acc[2]), f3 = __bfloat1622float2(acc[3]);
      os[v] = make_float4(f0.x, f0.y, f1.x, f1.y);
      os[v + kHalfVec] = make_float4(f2.x, f2.y, f3.x, f3.y);
    } else {
      float acc[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      alu_reps<kReps>(acc, reps, c);
      os[v] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      os[v + kHalfVec] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
}

template <bool kBf16>
void launch_alu(const float4* x, float4* out, int n_slabs, int reps, float c, cudaStream_t s) {
  auto kernel = alu_kernel<kBf16, 0>;
  if constexpr (!kBf16) {  // float32 at the tool's two counts: unrolled whole
    if (reps == 64) kernel = alu_kernel<false, 64>;
    if (reps == 2) kernel = alu_kernel<false, 2>;
  }
  kernel<<<n_slabs, kThreads, 0, s>>>(x, out, reps, c);
}


// ---------------------------------------------------------------------------
// Kernel T1b: the log-step inclusive prefix PRODUCT along the 128-deep axis
// of a [128, 1024] slab, `reps` times, each followed by * decay.
//
// Replaces tools/microbench_bf16_vpu.py::_scan_kernel (entry run). The TPU
// original compared two ways to shift along the scanned axis (pad + slice
// against roll + select); the card's ways are
//
//   * registers (the default): a thread holds its whole column (bf16: a
//     pair of columns in a __nv_bfloat162) in 128 registers and walks each
//     level in place from row 127 down to row s, v[i] = v[i] * v[i - s].
//     Row i - s has not been written yet at that level, so each multiply
//     is the plain version's x[i] * x[i - s]. No shift, no sync; the
//     multiplies of one level are independent. Blocks of 128 threads;
//   * lane shuffles: a warp holds one column, 4 contiguous values a lane,
//     and shifts with __shfl_up_sync (microbench_common.cuh::warp_scan128):
//     23 shuffles a column and rep, one a clock, set its pace;
//   * shared memory: a thread holds one value, writes it to a double
//     buffer, and reads the value `shift` rows up after one __syncthreads a
//     level.
//
// All three walk the plain version's tree, so float32 and bf16 agree to the
// bit. The shuffle and shared-memory forms give a slab one block of 1024
// threads. Bound: operations, the multiplies the tree needs: sum over the
// levels of (128 - s) = 769, plus 128 by the decay, a column and rep (a
// multiply by the pad 1.0 is exact and the register form skips it), none an
// FMA, at the rates named above.

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

constexpr int kRegThreads = 128;

// One level of the register form: rows 127 down to S, each times the row S
// above it, read before this level writes it. S is a template argument and
// the loop unrolls, so every index is a constant and the column never
// leaves the registers (a dynamic index would send it to local memory).
template <class V, int S>
__device__ __forceinline__ void tree_level(typename V::T (&v)[kDepth]) {
#pragma unroll
  for (int i = kDepth - 1; i >= S; --i) v[i] = V::Mul::apply(v[i], v[i - S]);
}

template <class V>
__global__ void __launch_bounds__(kRegThreads)
    scan_prod_reg_kernel(const float* __restrict__ x, float* __restrict__ out, int reps,
                         float decay) {
  using T = typename V::T;
  constexpr int kBlocksPerSlab = kWidth / V::kCols / kRegThreads;
  const int slab = blockIdx.x / kBlocksPerSlab;
  const int u = (blockIdx.x % kBlocksPerSlab) * kRegThreads + threadIdx.x;
  // a warp's loads of one row are 32 neighbouring columns (pairs)
  const float* xs = x + (size_t)slab * kDepth * kWidth + u * V::kCols;
  float* os = out + (size_t)slab * kDepth * kWidth + u * V::kCols;
  const T k = V::splat(decay);
  T v[kDepth];
#pragma unroll
  for (int i = 0; i < kDepth; ++i) v[i] = V::load(xs + i * kWidth);
  for (int r = 0; r < reps; ++r) {
    tree_level<V, 1>(v);
    tree_level<V, 2>(v);
    tree_level<V, 4>(v);
    tree_level<V, 8>(v);
    tree_level<V, 16>(v);
    tree_level<V, 32>(v);
    tree_level<V, 64>(v);
#pragma unroll
    for (int i = 0; i < kDepth; ++i) v[i] = V::Mul::apply(v[i], k);
  }
#pragma unroll
  for (int i = 0; i < kDepth; ++i) V::store(os + i * kWidth, v[i]);
}

}  // namespace

// x, out: [n_slabs, 128, 1024] f32. bf16 != 0 selects the packed bf16 path.
extern "C" int lfs_mb_alu_elementwise(const void* x, void* out, int n_slabs, int reps, float c,
                                      int bf16, void* stream) {
  if (n_slabs < 1 || reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const float4*>(x);
  const auto op = static_cast<float4*>(out);
  if (bf16) {
    launch_alu<true>(xp, op, n_slabs, reps, c, s);
  } else {
    launch_alu<false>(xp, op, n_slabs, reps, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out: [n_slabs, 128, 1024] f32. mode: 0 lane shuffles, 1 shared-memory
// shifts, 2 registers.
extern "C" int lfs_mb_scan_prod(const void* x, void* out, int n_slabs, int reps, float decay,
                                int bf16, int mode, void* stream) {
  if (n_slabs < 1 || reps < 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  if (mode == 2) {
    const int per_slab = kWidth / (bf16 ? Bf162::kCols : F32::kCols) / kRegThreads;
    auto kernel = bf16 ? scan_prod_reg_kernel<Bf162> : scan_prod_reg_kernel<F32>;
    kernel<<<n_slabs * per_slab, kRegThreads, 0, s>>>(xp, op, reps, decay);
  } else {
    auto kernel = mode == 1
                      ? (bf16 ? scan_prod_smem_kernel<Bf162> : scan_prod_smem_kernel<F32>)
                      : (bf16 ? scan_prod_shfl_kernel<Bf162> : scan_prod_shfl_kernel<F32>);
    kernel<<<n_slabs, kThreads, 0, s>>>(xp, op, reps, decay);
  }
  return static_cast<int>(cudaGetLastError());
}
