// The per-(pixel, instance) evaluation shared by the world-space blend
// kernels P5 (world_blend_forward.cu) and P6 (world_blend_backward.cu).
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

#pragma once

#include <cuda_runtime.h>

namespace lfs_world {

constexpr int kThreads = 256;
constexpr float kMaxAlpha = 0.999f;
constexpr float kLog2MaxS = 7.994353436858858f;  // log2(255): alpha_raw >= 1/255
constexpr float kDoneThreshold = 1e-4f;          // TRANSMITTANCE_THRESHOLD
constexpr float kLn2 = 0.6931471805599453f;

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

}  // namespace lfs_world
