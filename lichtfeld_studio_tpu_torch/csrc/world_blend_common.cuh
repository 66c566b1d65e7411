// What the world-space blend kernels P5 (world_blend_forward.cu) and P6
// (world_blend_backward.cu) share: the per-(pixel, instance) evaluation
// and the (warp patch, instance) bound in ray space.
//
// A gaussian's stream row (kernels/world_blend.py::pack_world_stream, f32):
//   global shutter, 24 floats: 0-8 C' (row-major), 9-17 M, 18 -log2(op),
//     19-22 colour (r, g, b, aux), 23 zero;
//   rolling shutter, 32 floats: 0-8 C0', 9-17 C1', 18-26 M, 27 -log2(op),
//     28-31 colour.
// For a pixel with world ray direction d (and shutter time tau):
//   y = C'd (rolling: C0'd + tau C1'd), z = Md,
//   s = |y|^2 / |z|^2 - log2(op)   (log2 units; C' carries 1/sqrt(2 ln 2)),
//   alpha = min(2^-s, 0.999), kept when s <= log2(255).
// This is the LINEAR form: y and z are evaluated from d, never the
// quadratic form d^T (C'^T C') d, which cancels like sin^2 and lost whole
// gaussians on trained models (world_blend_pallas.py:26-36).
//
// Every step is written with __fmul_rn / __fadd_rn / __fdiv_rn (no FMA
// contraction) in the operation order of the plain version
// (kernels/world_blend.py::_stream_alphas), so the keep and done tests fall
// on the same side as the plain version's on the same inputs.
//
// The ray-space bound. Once a tile, each warp takes its patch's centre ray
// d_c (the mean of its rays, by xor butterflies, so every lane holds the
// same bits) and the spread eps >= |d - d_c| over its pixels (rolling: also
// the spread of tau around tau_c, and the largest |d|). At the gather each
// instance's |C'|_F and |M|_F are stored with its row (rolling: |C0'|_F and
// |C1'|_F). For a pixel d = d_c + delta, |y| >= |C'd_c| - |C'|_F eps and
// |z| <= |Md_c| + |M|_F eps (rolling: y also moves by |tau - tau_c| |C1'|_F
// |d| and by |tau_c| |C1'|_F eps), so
//   s >= max(0, |y_c| - slack)^2 / (|z_c| + |M|_F eps)^2 - log2 op:
// one evaluation a (warp, instance) in place of 128. Where that exceeds
// log2(255) + kSkipMargin no pixel of the patch keeps the instance, so
// skipping it changes no bit of any output. Margins: eps is taken 0.1%
// larger plus 1e-5 |d| (which also covers the rounding of y and z, ~1e-7
// |C'| |d|), and 1e-3 on s (rounding of the bound, ~1e-6 relative). No skip
// where any term is non-finite or the bound's |z|^2 falls under 1e-29 (the
// evaluation clamps |z|^2 at 1e-30). The plain mirror:
// kernels/world_blend.py::patch_ray_skip_group.

#pragma once

#include <cuda_runtime.h>

namespace lfs_world {

constexpr int kThreads = 256;
constexpr float kMaxAlpha = 0.999f;
constexpr float kLog2MaxS = 7.994353436858858f;  // log2(255): alpha_raw >= 1/255
constexpr float kDoneThreshold = 1e-4f;          // TRANSMITTANCE_THRESHOLD
constexpr float kLn2 = 0.6931471805599453f;
// Margins of the ray-space bound: on the patch's ray spread (relative, and
// absolute times the largest |d|: the rounding of y and z), on s, and the
// least |z|^2 bound it trusts.
constexpr float kRayRel = 1.001f;
constexpr float kRayAbs = 1e-5f;
constexpr float kSkipMargin = 1e-3f;
constexpr float kMinDen = 1e-29f;

template <bool kRS>
struct Layout {
  static constexpr int kRows = kRS ? 32 : 24;  // floats per stream row
  static constexpr int kZ = kRS ? 18 : 9;      // first M entry
  static constexpr int kNlog = kRS ? 27 : 18;  // -log2(opacity)
  static constexpr int kColor = kRS ? 28 : 19; // r, g, b, aux
};

// The direction goes in as three scalars, not an array, so that the
// per-pixel state stays in registers (an array argument put it on the
// stack, 64 bytes a thread at 32-px tiles).
__device__ __forceinline__ float lin3(const float* r, float d0, float d1, float d2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], d0), __fmul_rn(r[1], d1)), __fmul_rn(r[2], d2));
}

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

// One (pixel, instance) evaluation: y, z, |y|^2, |z|^2 and s.
struct WorldEval {
  float y0, y1, y2, z0, z1, z2, num, den, s;
};

template <bool kRS>
__device__ __forceinline__ WorldEval world_eval(const float* f, float d0, float d1, float d2,
                                                float tau) {
  using L = Layout<kRS>;
  WorldEval e;
  e.y0 = lin3(f + 0, d0, d1, d2);
  e.y1 = lin3(f + 3, d0, d1, d2);
  e.y2 = lin3(f + 6, d0, d1, d2);
  if constexpr (kRS) {
    e.y0 = __fadd_rn(e.y0, __fmul_rn(tau, lin3(f + 9, d0, d1, d2)));
    e.y1 = __fadd_rn(e.y1, __fmul_rn(tau, lin3(f + 12, d0, d1, d2)));
    e.y2 = __fadd_rn(e.y2, __fmul_rn(tau, lin3(f + 15, d0, d1, d2)));
  }
  e.z0 = lin3(f + L::kZ, d0, d1, d2);
  e.z1 = lin3(f + L::kZ + 3, d0, d1, d2);
  e.z2 = lin3(f + L::kZ + 6, d0, d1, d2);
  e.num = sq3(e.y0, e.y1, e.y2);
  e.den = sq3(e.z0, e.z1, e.z2);
  e.s = __fadd_rn(__fdiv_rn(e.num, fmaxf(e.den, 1e-30f)), f[L::kNlog]);
  return e;
}

__device__ __forceinline__ float norm9(const float* r) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) s += r[i] * r[i];
  return sqrtf(s);
}

// What the bound reads of a stream row, stored beside it at the gather:
// |C'|_F (rolling |C0'|_F), |C1'|_F (rolling only), |M|_F.
template <bool kRS>
__device__ __forceinline__ float4 row_norms(const float* row) {
  return make_float4(norm9(row), kRS ? norm9(row + 9) : 0.0f, norm9(row + Layout<kRS>::kZ), 0.0f);
}

// A warp's patch in ray space: centre ray and time, their spreads, the
// largest |d|, and whether all of them are finite (every lane the same bits).
struct RayPatch {
  float c0, c1, c2, ct, eps, eps_t, dmax;
  bool finite;
};

template <int kPerThread>
__device__ __forceinline__ RayPatch ray_patch(const float (&d)[kPerThread][3],
                                              const float (&tp)[kPerThread]) {
  constexpr unsigned kFull = 0xffffffffu;
  RayPatch p;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, ct = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) c0 += d[i][0], c1 += d[i][1], c2 += d[i][2], ct += tp[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    c0 += __shfl_xor_sync(kFull, c0, o);
    c1 += __shfl_xor_sync(kFull, c1, o);
    c2 += __shfl_xor_sync(kFull, c2, o);
    ct += __shfl_xor_sync(kFull, ct, o);
  }
  constexpr float kInvN = 1.0f / (32 * kPerThread);
  c0 *= kInvN, c1 *= kInvN, c2 *= kInvN, ct *= kInvN;
  float eps = 0.0f, eps_t = 0.0f, dmax = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const float e0 = d[i][0] - c0, e1 = d[i][1] - c1, e2 = d[i][2] - c2;
    eps = fmaxf(eps, sqrtf(e0 * e0 + e1 * e1 + e2 * e2));
    dmax = fmaxf(dmax, sqrtf(d[i][0] * d[i][0] + d[i][1] * d[i][1] + d[i][2] * d[i][2]));
    eps_t = fmaxf(eps_t, fabsf(tp[i] - ct));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    eps = fmaxf(eps, __shfl_xor_sync(kFull, eps, o));
    dmax = fmaxf(dmax, __shfl_xor_sync(kFull, dmax, o));
    eps_t = fmaxf(eps_t, __shfl_xor_sync(kFull, eps_t, o));
  }
  p.c0 = c0, p.c1 = c1, p.c2 = c2, p.ct = ct;
  p.eps = eps * kRayRel + kRayAbs * dmax;
  p.eps_t = eps_t * kRayRel + kRayAbs;
  p.dmax = dmax * kRayRel;
  // a non-finite ray anywhere in the patch: the sums are not finite, no skip
  p.finite = isfinite(c0 + c1 + c2 + ct + p.eps + p.eps_t + p.dmax);
  return p;
}

// The bound of an instance (row f, its row_norms nrm) over a patch:
// whether no pixel of the patch can keep it (s > log2 255), and an upper
// bound of |z|^2 over the patch's pixels (infinite where the bound is not
// trusted).
struct RayBound {
  bool skip;
  float den_hi;
};

template <bool kRS>
__device__ __forceinline__ RayBound ray_bound(const RayPatch& p, const float* f, float4 nrm) {
  using L = Layout<kRS>;
  float y[3], z[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    y[r] = lin3(f + 3 * r, p.c0, p.c1, p.c2);
    if constexpr (kRS) y[r] = __fadd_rn(y[r], __fmul_rn(p.ct, lin3(f + 9 + 3 * r, p.c0, p.c1, p.c2)));
    z[r] = lin3(f + L::kZ + 3 * r, p.c0, p.c1, p.c2);
  }
  const float yl = sqrtf(sq3(y[0], y[1], y[2]));
  const float zl = sqrtf(sq3(z[0], z[1], z[2]));
  const float slack = (nrm.x + fabsf(p.ct) * nrm.y) * p.eps + (kRS ? nrm.y * p.eps_t * p.dmax : 0.0f);
  const float lo = fmaxf(yl - slack, 0.0f);
  const float hi = zl + nrm.z * p.eps;
  const float den = hi * hi;
  const float nlog = f[L::kNlog];
  const bool trusted = p.finite && isfinite(yl + zl + slack + den + nlog) && den >= kMinDen;
  return {trusted && lo * lo / den + nlog > kLog2MaxS + kSkipMargin, trusted ? den : INFINITY};
}

// world_eval in two steps, with the same bits: |y|^2 first, then s from it.
template <bool kRS>
__device__ __forceinline__ float world_num(const float* f, float d0, float d1, float d2,
                                           float tau) {
  float y0 = lin3(f + 0, d0, d1, d2), y1 = lin3(f + 3, d0, d1, d2), y2 = lin3(f + 6, d0, d1, d2);
  if constexpr (kRS) {
    y0 = __fadd_rn(y0, __fmul_rn(tau, lin3(f + 9, d0, d1, d2)));
    y1 = __fadd_rn(y1, __fmul_rn(tau, lin3(f + 12, d0, d1, d2)));
    y2 = __fadd_rn(y2, __fmul_rn(tau, lin3(f + 15, d0, d1, d2)));
  }
  return sq3(y0, y1, y2);
}

template <bool kRS>
__device__ __forceinline__ float world_s(const float* f, float num, float d0, float d1, float d2) {
  using L = Layout<kRS>;
  const float den = sq3(lin3(f + L::kZ, d0, d1, d2), lin3(f + L::kZ + 3, d0, d1, d2),
                        lin3(f + L::kZ + 6, d0, d1, d2));
  return __fadd_rn(__fdiv_rn(num, fmaxf(den, 1e-30f)), f[L::kNlog]);
}

// The least |y|^2 above which a pixel whose |z|^2 is at most den_hi cannot
// keep an instance with -log2(op) = nlog, or +inf. With m = (log2(255) -
// nlog)(1 + 1e-6) + 1e-5 and |y|^2 > m den_hi (1 + 1e-5) >= m max(|z|^2,
// 1e-30): |y|^2 / max(|z|^2, 1e-30) exceeds log2(255) - nlog by 1e-5 after
// every rounding of the product, the division and the sum (each within
// 6e-8 relative; all terms >= 0), so s > log2(255). Where m < 0, nlog
// alone exceeds log2(255) by more than 1e-5, and s >= nlog.
__device__ __forceinline__ float reject_above(float nlog, float den_hi) {
  const float m = (kLog2MaxS - nlog) * (1.0f + 1e-6f) + 1e-5f;
  const float t = m * den_hi * (1.0f + 1e-5f);
  return isfinite(den_hi) && !isnan(t) ? t : INFINITY;
}

}  // namespace lfs_world
