// EWA projection with SH colour: one forward and one backward kernel.
//
// Replaces no TPU kernel: the JAX package leaves the projection
// (lichtfeld_studio_tpu/ops/projection.py::project_gaussians, ops/sh.py::
// sh_to_color) to XLA, which fuses it. Its plain PyTorch form
// (lichtfeld_studio_tpu_torch/ops/projection.py) is a few hundred
// elementwise launches over [C] and [16, C] tensors, with their
// intermediates in device memory and their autograd nodes on the host. The
// shape of the two kernels is the upstream's preprocess: fastgs
// kernels_forward.cuh:18-205 forward and the reference's preprocess
// backward, one thread per gaussian.
//
// What bounds them on the H100: device-memory traffic alone. The forward
// reads the 59 floats of a gaussian (means, log-scales, quaternion, logit,
// sh0, shN) and a live flag, and writes the 16 words of ProjectedSplats
// (~300 B a gaussian, ~0.09 ms at 1M and 3.35 TB/s); the backward reads the
// same inputs and the 10 floats of the outputs' gradients, and writes the 59
// floats of the parameters' gradients (~510 B, ~0.15 ms). The arithmetic,
// a few hundred float operations a gaussian, is a tenth of that at 67
// TFLOP/s. So the design is about touching each byte once:
//
//   * nothing is saved between the two: the backward recomputes the
//     forward's intermediates from the inputs, in registers;
//   * shN, 180 of the 236 bytes a gaussian reads, is staged by the block
//     into shared memory with 16-byte cp.async copies that neighbouring
//     threads issue on neighbouring addresses (a block's rows are one
//     contiguous range); each thread then reads its row there. The row
//     stride of 45 floats is odd, so a warp's 32 rows fall in 32 banks. The
//     backward writes d shN into the same rows and the block stores them
//     with coalesced 16-byte stores;
//   * the exact tile test runs over at most exact_tile_cap (16 or 32) cells
//     in registers, building the bitmask and n_touched with no [K, C]
//     intermediate;
//   * the active SH degree is read from its device scalar: no host sync.
//
// Rounding. The chain that decides which gaussians are kept and which tiles
// they hit (depth, opacity, |q|^2, the rotation, the EWA Jacobian, cov2d,
// det, conic, mean2d, the power threshold, the extents, floor and ceil, the
// tile index's NaN and saturation rules and the exact tile test) rounds as
// the plain path does on the card: every operation is a separately rounded
// __f*_rn intrinsic in the plain path's order (no FMA contraction), expf,
// logf and sqrtf are the IEEE library calls PyTorch's kernels call, clamps
// and minimum / maximum propagate NaN as torch's do, and the sums that the
// plain path takes with torch.sum follow the order of PyTorch's reduction
// kernel (sum3_last, sum4_last, sum_rows below). So valid, bbox, n_touched
// and tile_mask equal the plain path's bit for bit, and so do depth,
// mean2d, conic, opacity and the SH colour (its direction norm summed as
// torch.linalg.norm sums it). The backward is the closed form of the plain
// path's autograd, in plain float arithmetic (contraction allowed).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // gaussians a block owns

// --- float32 as the plain path rounds it ------------------------------------

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(min=) and torch.clamp(0, 1) on the card: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}
// torch.maximum / torch.minimum: NaN in either operand wins
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch.sum over the last axis of [C, 3] and [C, 4] (PyTorch's reduction
// kernel gives two lanes to either, each summing every second value, then
// adds the lanes: (a + c) + b, (a + c) + (b + d)), and over a middle axis
// (one thread, four interleaved accumulators, then combined in order); the
// orders as measured on the card against torch 2.11
__device__ __forceinline__ float sum3_last(float a, float b, float c) { return add(add(a, c), b); }
__device__ __forceinline__ float sum4_last(float a, float b, float c, float d) {
  return add(add(a, c), add(b, d));
}
template <int kN>
__device__ __forceinline__ float sum_rows(const float* t) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i & 3] = add(acc[i & 3], t[i]);
  return add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
}

template <typename T>
__device__ __forceinline__ float F(T v) {  // a constant as the plain path casts it
  return static_cast<float>(v);
}

// --- constants (ops/projection.py, ops/sh.py) --------------------------------

constexpr double kDilation = 0.3;
constexpr double kAlphaMin = 1.0 / 255.0;
constexpr double kAlphaMinRcp = 255.0;
constexpr double kShC0 = 0.28209479177387814;
constexpr double kC1 = 0.48860251190291987;
constexpr double kC2_0 = 1.0925484305920792, kC2_1 = -1.0925484305920792,
                 kC2_2 = 0.94617469575755997, kC2_3 = -0.31539156525251999,
                 kC2_4 = 0.54627421529603959;
constexpr double kC3_0 = 0.59004358992664352, kC3_1 = 2.8906114426405538,
                 kC3_2 = 0.45704579946446572, kC3_3 = 0.3731763325901154,
                 kC3_4 = 1.4453057213202769;

// --- the camera ----------------------------------------------------------------

struct Frame {  // host-side scalars, rounded to float32 as torch rounds Python floats
  float clip_x0, clip_x1, clip_y0, clip_y1;  // -0.15 W, 1.15 W, -0.15 H, 1.15 H
  float near_plane, far_plane;
  float pad, pad2, span;  // dilate_px, 2 dilate_px, (tile - 1) + 2 dilate_px
  float tile;
  int grid_w, grid_h, tile_size, cap;
};

struct Camera {
  float r[3][3], t[3];  // world to camera
  float fx, fy, cx, cy;
  float clip_l, clip_r, clip_t, clip_b;  // the 15 %-expanded frustum in normalised coordinates
  float pos[3];
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ w2c,
                                              const float* __restrict__ k,
                                              const float* __restrict__ cam_pos,
                                              const Frame& fr) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.r[i][j] = w2c[4 * i + j];
    c.t[i] = w2c[4 * i + 3];
    c.pos[i] = cam_pos[i];
  }
  c.fx = k[0];
  c.fy = k[1];
  c.cx = k[2];
  c.cy = k[3];
  c.clip_l = dvd(sub(fr.clip_x0, c.cx), c.fx);
  c.clip_r = dvd(sub(fr.clip_x1, c.cx), c.fx);
  c.clip_t = dvd(sub(fr.clip_y0, c.cy), c.fy);
  c.clip_b = dvd(sub(fr.clip_y1, c.cy), c.fy);
  return c;
}

// --- the forward's geometry, shared by both kernels -------------------------------

struct Ewa {
  float p[3];                   // camera-space mean
  float sdep;                   // safe depth
  bool sdep_ok;                 // |depth| > 1e-12
  float x, y, mx, my, tx, ty;   // normalised coordinates, after max, after min (clamped)
  float j11, j13, j22, j23;     // the Jacobian
  float jw1[3], jw2[3];         // its rows times the camera rotation
  float w, qx, qy, qz;          // the quaternion
  float nsum, s;                // |q|^2 as quat_to_rotmat sums it, 2 / max(|q|^2, 1e-24)
  float rot[3][3];              // the gaussian's rotation
  float var[3];                 // exp(2 log_scale)
  float u1[3], u2[3];           // (J W R)
  float cxx, cxy, cyy;          // cov2d, dilated
  float det, sd;                // its determinant, the safe one
  bool sd_ok;                   // |det| > 1e-12
};

__device__ __forceinline__ void camera_point(const Camera& c, const float m[3], float p[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = add(add(add(mul(m[0], c.r[i][0]), mul(m[1], c.r[i][1])), mul(m[2], c.r[i][2])), c.t[i]);
}

__device__ __forceinline__ void ewa(const Camera& c, const float m[3], const float ls[3],
                                    const float q[4], Ewa& e) {
  camera_point(c, m, e.p);
  const float depth = e.p[2];
  e.sdep_ok = fabsf(depth) > F(1e-12);
  e.sdep = e.sdep_ok ? depth : F(1e-12);
  e.x = dvd(e.p[0], e.sdep);
  e.y = dvd(e.p[1], e.sdep);
  e.mx = maximum(e.x, c.clip_l);
  e.tx = minimum(e.mx, c.clip_r);
  e.my = maximum(e.y, c.clip_t);
  e.ty = minimum(e.my, c.clip_b);
  e.j11 = dvd(c.fx, e.sdep);
  e.j13 = mul(-e.j11, e.tx);
  e.j22 = dvd(c.fy, e.sdep);
  e.j23 = mul(-e.j22, e.ty);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e.jw1[k] = add(mul(e.j11, c.r[0][k]), mul(e.j13, c.r[2][k]));
    e.jw2[k] = add(mul(e.j22, c.r[1][k]), mul(e.j23, c.r[2][k]));
  }
  // quat_to_rotmat (ops/gaussians.py)
  e.w = q[0];
  e.qx = q[1];
  e.qy = q[2];
  e.qz = q[3];
  e.nsum = add(add(add(mul(e.w, e.w), mul(e.qx, e.qx)), mul(e.qy, e.qy)), mul(e.qz, e.qz));
  e.s = dvd(2.0f, clamp_min(e.nsum, F(1e-24)));
  const float sx = mul(e.s, e.qx), sy = mul(e.s, e.qy), sz = mul(e.s, e.qz), sw = mul(e.s, e.w);
  const float xx = mul(sx, e.qx), yy = mul(sy, e.qy), zz = mul(sz, e.qz);
  const float xy = mul(sx, e.qy), xz = mul(sx, e.qz), yz = mul(sy, e.qz);
  const float wx = mul(sw, e.qx), wy = mul(sw, e.qy), wz = mul(sw, e.qz);
  e.rot[0][0] = sub(1.0f, add(yy, zz));
  e.rot[0][1] = sub(xy, wz);
  e.rot[0][2] = add(wy, xz);
  e.rot[1][0] = add(wz, xy);
  e.rot[1][1] = sub(1.0f, add(xx, zz));
  e.rot[1][2] = sub(yz, wx);
  e.rot[2][0] = sub(xz, wy);
  e.rot[2][1] = add(wx, yz);
  e.rot[2][2] = sub(1.0f, add(xx, yy));
#pragma unroll
  for (int k = 0; k < 3; ++k) e.var[k] = expf(mul(2.0f, ls[k]));
  // u1 = (jw1[:, :, None] * rot).sum(1): a middle axis
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    e.u1[j] = add(add(mul(e.jw1[0], e.rot[0][j]), mul(e.jw1[1], e.rot[1][j])),
                  mul(e.jw1[2], e.rot[2][j]));
    e.u2[j] = add(add(mul(e.jw2[0], e.rot[0][j]), mul(e.jw2[1], e.rot[1][j])),
                  mul(e.jw2[2], e.rot[2][j]));
  }
  float txx[3], txy[3], tyy[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    txx[k] = mul(mul(e.var[k], e.u1[k]), e.u1[k]);
    txy[k] = mul(mul(e.var[k], e.u1[k]), e.u2[k]);
    tyy[k] = mul(mul(e.var[k], e.u2[k]), e.u2[k]);
  }
  e.cxx = add(sum3_last(txx[0], txx[1], txx[2]), F(kDilation));
  e.cxy = sum3_last(txy[0], txy[1], txy[2]);
  e.cyy = add(sum3_last(tyy[0], tyy[1], tyy[2]), F(kDilation));
  e.det = sub(mul(e.cxx, e.cyy), mul(e.cxy, e.cxy));
  e.sd_ok = fabsf(e.det) > F(1e-12);
  e.sd = e.sd_ok ? e.det : F(1e-12);
}

__device__ __forceinline__ float sigmoid(float v) { return dvd(1.0f, add(1.0f, expf(-v))); }

// the unnormalised view direction and its norm (ops/sh.py::sh_to_color)
__device__ __forceinline__ float view_dir(const Camera& c, const float m[3], float dir[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) dir[i] = sub(m[i], c.pos[i]);
  return sqrtf(add(add(mul(dir[0], dir[0]), mul(dir[2], dir[2])), mul(dir[1], dir[1])));
}

// eval_sh_bases' first 15 (l = 1..3) at a unit direction
__device__ __forceinline__ void sh_bases(float x, float y, float z, float b[15]) {
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  b[0] = mul(F(-kC1), y);
  b[1] = mul(F(kC1), z);
  b[2] = mul(F(-kC1), x);
  b[3] = mul(F(kC2_0), xy);
  b[4] = mul(F(kC2_1), yz);
  b[5] = add(mul(F(kC2_2), zz), F(kC2_3));
  b[6] = mul(F(-kC2_0), xz);
  b[7] = mul(F(kC2_4), sub(xx, yy));
  b[8] = mul(mul(F(kC3_0), y), add(mul(-3.0f, xx), yy));
  b[9] = mul(mul(F(kC3_1), xy), z);
  b[10] = mul(mul(F(kC3_2), y), sub(1.0f, mul(5.0f, zz)));
  b[11] = mul(mul(F(kC3_3), z), sub(mul(5.0f, zz), 3.0f));
  b[12] = mul(mul(F(kC3_2), x), sub(1.0f, mul(5.0f, zz)));
  b[13] = mul(mul(F(kC3_4), z), sub(xx, yy));
  b[14] = mul(mul(F(kC3_0), x), add(-xx, mul(3.0f, yy)));
}

// d b_i / d (x, y, z) of the 15 bases, x, y, z taken as independent (autograd's view)
__device__ __forceinline__ void sh_bases_grad(float x, float y, float z, const float gb[15],
                                              float gd[3]) {
  const float c1 = F(kC1);
  const float c20 = F(kC2_0), c21 = F(kC2_1), c22 = F(kC2_2), c24 = F(kC2_4);
  const float c30 = F(kC3_0), c31 = F(kC3_1), c32 = F(kC3_2), c33 = F(kC3_3),
              c34 = F(kC3_4);
  const float xx = x * x, yy = y * y, zz = z * z;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  gy -= c1 * gb[0];
  gz += c1 * gb[1];
  gx -= c1 * gb[2];
  gx += c20 * y * gb[3];
  gy += c20 * x * gb[3];
  gy += c21 * z * gb[4];
  gz += c21 * y * gb[4];
  gz += 2.0f * c22 * z * gb[5];
  gx -= c20 * z * gb[6];
  gz -= c20 * x * gb[6];
  gx += 2.0f * c24 * x * gb[7];
  gy -= 2.0f * c24 * y * gb[7];
  gx += -6.0f * c30 * x * y * gb[8];
  gy += 3.0f * c30 * (yy - xx) * gb[8];
  gx += c31 * y * z * gb[9];
  gy += c31 * x * z * gb[9];
  gz += c31 * x * y * gb[9];
  gy += c32 * (1.0f - 5.0f * zz) * gb[10];
  gz += -10.0f * c32 * y * z * gb[10];
  gz += c33 * (15.0f * zz - 3.0f) * gb[11];
  gx += c32 * (1.0f - 5.0f * zz) * gb[12];
  gz += -10.0f * c32 * x * z * gb[12];
  gx += 2.0f * c34 * x * z * gb[13];
  gy -= 2.0f * c34 * y * z * gb[13];
  gz += c34 * (xx - yy) * gb[13];
  gx += 3.0f * c30 * (yy - xx) * gb[14];
  gy += 6.0f * c30 * x * y * gb[14];
  gd[0] = gx;
  gd[1] = gy;
  gd[2] = gz;
}

// --- shN rows through shared memory -------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Copy n_floats floats from src (16-byte aligned) into s, the block's
// threads on neighbouring 16-byte pieces; the last, partial piece by scalars.
__device__ __forceinline__ void stage_rows(float* s, const float* __restrict__ src, int n_floats) {
  const int n_vec = n_floats >> 2;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) cp_async16(s + 4 * i, src + 4 * i);
  for (int i = 4 * n_vec + threadIdx.x; i < n_floats; i += kThreads) s[i] = src[i];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// --- the forward ---------------------------------------------------------------------

struct FwdArgs {
  const float* means;
  const float* log_scales;
  const float* quats;
  const float* logits;
  const float* sh0;
  const float* shN;  // [n, kRest, 3], 16-byte aligned
  const uint8_t* active;
  const int* sh_degree;
  const float* w2c;
  const float* cam_pos;
  const float* k;
  int n;
  Frame fr;
  float* depth;
  float* mean2d;
  float* conic;
  float* opacity;
  float* color;
  int4* bbox;
  int* n_touched;
  uint8_t* valid;
  int* tile_mask;
};

// float -> tile index clipped to [0, hi] (ops/projection.py::_tile_index)
__device__ __forceinline__ int tile_index(float v, int hi) {
  const float fhi = static_cast<float>(hi);
  if (v != v) v = 0.0f;
  else if (isinf(v)) v = v > 0.0f ? fhi : 0.0f;
  return static_cast<int>(fminf(fmaxf(v, 0.0f), fhi));
}

// ops/projection.py::_will_contribute for one tile, mx / my less 0.5
__device__ __forceinline__ bool will_contribute(float mx, float my, float ca, float cb, float cc,
                                                int tile_x, int tile_y, float power_threshold,
                                                const Frame& fr) {
  const float rmin_x = sub(static_cast<float>(tile_x * fr.tile_size), fr.pad);
  const float rmin_y = sub(static_cast<float>(tile_y * fr.tile_size), fr.pad);
  const float rmax_x = add(add(rmin_x, static_cast<float>(fr.tile_size - 1)), fr.pad2);
  const float rmax_y = add(add(rmin_y, static_cast<float>(fr.tile_size - 1)), fr.pad2);
  const float xmd = sub(rmin_x, mx);
  const float x_left = xmd > 0.0f ? 1.0f : 0.0f;
  const float not_in_x = add(x_left, mx > rmax_x ? 1.0f : 0.0f);
  const float ymd = sub(rmin_y, my);
  const float y_above = ymd > 0.0f ? 1.0f : 0.0f;
  const float not_in_y = add(y_above, my > rmax_y ? 1.0f : 0.0f);
  if (add(not_in_x, not_in_y) == 0.0f) return true;
  const float closest_x = add(rmax_x, mul(x_left, sub(rmin_x, rmax_x)));
  const float closest_y = add(rmax_y, mul(y_above, sub(rmin_y, rmax_y)));
  const float diff_x = sub(mx, closest_x);
  const float diff_y = sub(my, closest_y);
  const float d_x = xmd > 0.0f ? fr.span : -fr.span;
  const float d_y = ymd > 0.0f ? fr.span : -fr.span;
  const float dxa = mul(d_x, ca);
  const float t_x = mul(not_in_y, clamp01(dvd(add(mul(dxa, diff_x), mul(mul(d_x, cb), diff_y)),
                                               mul(dxa, d_x))));
  const float dyc = mul(d_y, cc);
  const float t_y = mul(not_in_x, clamp01(dvd(add(mul(mul(d_y, cb), diff_x), mul(dyc, diff_y)),
                                               mul(dyc, d_y))));
  const float dx = sub(mx, add(closest_x, mul(t_x, d_x)));
  const float dy = sub(my, add(closest_y, mul(t_y, d_y)));
  const float max_power =
      add(mul(0.5f, add(mul(mul(ca, dx), dx), mul(mul(cc, dy), dy))), mul(mul(cb, dx), dy));
  return max_power <= power_threshold;
}

template <int kRest, bool kAA>
__global__ void __launch_bounds__(kThreads) project_ewa_forward_kernel(FwdArgs a) {
  constexpr int kRow = 3 * kRest;
  __shared__ __align__(16) float s_sh[kRow > 0 ? kThreads * kRow : 4];
  const int g0 = blockIdx.x * kThreads;
  if constexpr (kRow > 0) stage_rows(s_sh, a.shN + (size_t)g0 * kRow, min(kThreads, a.n - g0) * kRow);
  const int g = g0 + threadIdx.x;
  if (g >= a.n) return;
  const Frame& fr = a.fr;
  const Camera c = load_camera(a.w2c, a.k, a.cam_pos, fr);

  float m[3], ls[3], q[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[i] = a.means[3 * g + i];
    ls[i] = a.log_scales[3 * g + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = a.quats[4 * g + i];

  Ewa e;
  ewa(c, m, ls, q, e);
  const float depth = e.p[2];
  bool valid = a.active[g] != 0 && depth >= fr.near_plane && depth <= fr.far_plane;
  const float sig = sigmoid(a.logits[g]);
  valid &= sig >= F(kAlphaMin);
  valid &= sum4_last(mul(q[0], q[0]), mul(q[1], q[1]), mul(q[2], q[2]), mul(q[3], q[3])) >= F(1e-8);
  valid &= e.det >= F(1e-8);
  const float ca = dvd(e.cyy, e.sd), cb = dvd(-e.cxy, e.sd), cc = dvd(e.cxx, e.sd);
  float op = sig;
  if (kAA) {  // Mip-Splatting compensation
    const float det_raw =
        sub(mul(sub(e.cxx, F(kDilation)), sub(e.cyy, F(kDilation))), mul(e.cxy, e.cxy));
    const float r = dvd(clamp_min(det_raw, 0.0f), e.sd);
    op = mul(op, r > 0.0f ? sqrtf(r) : 0.0f);
    valid &= op >= F(kAlphaMin);
  }
  const float m2x = add(mul(e.x, c.fx), c.cx);
  const float m2y = add(mul(e.y, c.fy), c.cy);

  // conservative tile bounds (ops/projection.py::screen_bounds)
  const float power_threshold = logf(mul(clamp_min(op, F(kAlphaMin)), F(kAlphaMinRcp)));
  const float ptf = sqrtf(clamp_min(mul(2.0f, power_threshold), 0.0f));
  const float ext_x =
      add(clamp_min(sub(mul(ptf, sqrtf(clamp_min(e.cxx, 0.0f))), 0.5f), 0.0f), fr.pad);
  const float ext_y =
      add(clamp_min(sub(mul(ptf, sqrtf(clamp_min(e.cyy, 0.0f))), 0.5f), 0.0f), fr.pad);
  const int x_min = tile_index(floorf(dvd(sub(m2x, ext_x), fr.tile)), fr.grid_w);
  const int x_max = tile_index(ceilf(dvd(add(m2x, ext_x), fr.tile)), fr.grid_w);
  const int y_min = tile_index(floorf(dvd(sub(m2y, ext_y), fr.tile)), fr.grid_h);
  const int y_max = tile_index(ceilf(dvd(add(m2y, ext_y), fr.tile)), fr.grid_h);
  const int bb_w = x_max - x_min;
  const int area = bb_w * (y_max - y_min);
  valid &= area > 0;
  int n_touched = area;
  unsigned mask = 0u;
  if (fr.cap > 0 && valid && area <= fr.cap) {  // the exact test over the bbox's cells
    const float mxh = sub(m2x, 0.5f), myh = sub(m2y, 0.5f);
    n_touched = 0;
    for (int k = 0; k < area; ++k) {
      if (will_contribute(mxh, myh, ca, cb, cc, x_min + k % bb_w, y_min + k / bb_w,
                          power_threshold, fr)) {
        mask |= 1u << k;
        ++n_touched;
      }
    }
    valid &= n_touched > 0;
  }
  if (!valid) {
    n_touched = 0;
    mask = 0u;
  }

  // SH colour at the active degree
  float col[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) col[ch] = add(0.5f, mul(F(kShC0), a.sh0[3 * g + ch]));
  if constexpr (kRest > 0) {
    float dir[3];
    const float nc = clamp_min(view_dir(c, m, dir), F(1e-12));
    float b[15];
    sh_bases(dvd(dir[0], nc), dvd(dir[1], nc), dvd(dir[2], nc), b);
    const int deg = *a.sh_degree;
    const int active_bases = (deg + 1) * (deg + 1);
    const float* row = s_sh + threadIdx.x * kRow;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float t[kRest];
#pragma unroll
      for (int i = 0; i < kRest; ++i)
        t[i] = mul(mul(b[i], i + 1 < active_bases ? 1.0f : 0.0f), row[3 * i + ch]);
      col[ch] = add(col[ch], sum_rows<kRest>(t));
    }
  }

  a.depth[g] = depth;
  reinterpret_cast<float2*>(a.mean2d)[g] = make_float2(m2x, m2y);
  a.conic[3 * g + 0] = ca;
  a.conic[3 * g + 1] = cb;
  a.conic[3 * g + 2] = cc;
  a.opacity[g] = op;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) a.color[3 * g + ch] = col[ch];
  a.bbox[g] = make_int4(x_min, x_max, y_min, y_max);
  a.n_touched[g] = n_touched;
  a.valid[g] = valid ? 1 : 0;
  a.tile_mask[g] = static_cast<int>(mask);
}

// --- the backward ----------------------------------------------------------------------

struct BwdArgs {
  const float* means;
  const float* log_scales;
  const float* quats;
  const float* logits;
  const float* shN;  // [n, kRest, 3], 16-byte aligned
  const int* sh_degree;
  const float* w2c;
  const float* cam_pos;
  const float* k;
  int n;
  Frame fr;
  // the outputs' gradients, each a row stride (floats) apart; null reads 0
  const float* g_depth;
  const float* g_mean2d;
  const float* g_conic;
  const float* g_opacity;
  const float* g_color;
  int s_depth, s_mean2d, s_conic, s_opacity, s_color;
  float* d_means;
  float* d_log_scales;
  float* d_quats;
  float* d_logits;
  float* d_sh0;
  float* d_shN;  // [n, kRest, 3], 16-byte aligned
};

__device__ __forceinline__ float grad_in(const float* p, int stride, int g, int j) {
  return p != nullptr ? p[(size_t)g * stride + j] : 0.0f;
}

// d max(a, b) / d a and d min(a, b) / d a as autograd gives them: half at a tie
__device__ __forceinline__ float dmax_da(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dmin_da(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

template <int kRest, bool kAA>
__global__ void __launch_bounds__(kThreads) project_ewa_backward_kernel(BwdArgs a) {
  constexpr int kRow = 3 * kRest;
  __shared__ __align__(16) float s_sh[kRow > 0 ? kThreads * kRow : 4];
  const int g0 = blockIdx.x * kThreads;
  const int nb = min(kThreads, a.n - g0);
  if constexpr (kRow > 0) stage_rows(s_sh, a.shN + (size_t)g0 * kRow, nb * kRow);
  const int g = g0 + threadIdx.x;
  if (g < a.n) {
    const Camera c = load_camera(a.w2c, a.k, a.cam_pos, a.fr);
    float m[3], ls[3], q[4];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      m[i] = a.means[3 * g + i];
      ls[i] = a.log_scales[3 * g + i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = a.quats[4 * g + i];
    Ewa e;
    ewa(c, m, ls, q, e);
    const float sig = sigmoid(a.logits[g]);

    const float g_depth = grad_in(a.g_depth, a.s_depth, g, 0);
    const float g_m2x = grad_in(a.g_mean2d, a.s_mean2d, g, 0);
    const float g_m2y = grad_in(a.g_mean2d, a.s_mean2d, g, 1);
    const float g_a = grad_in(a.g_conic, a.s_conic, g, 0);
    const float g_b = grad_in(a.g_conic, a.s_conic, g, 1);
    const float g_c = grad_in(a.g_conic, a.s_conic, g, 2);
    const float g_op = grad_in(a.g_opacity, a.s_opacity, g, 0);
    float g_col[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) g_col[ch] = grad_in(a.g_color, a.s_color, g, ch);

    // opacity, and the compensation's share of cov2d
    float g_cxx = 0.0f, g_cxy = 0.0f, g_cyy = 0.0f, g_sd = 0.0f, g_sig = g_op;
    if (kAA) {
      const float dx0 = e.cxx - F(kDilation), dy0 = e.cyy - F(kDilation);
      const float det_raw = dx0 * dy0 - e.cxy * e.cxy;
      const float r = clamp_min(det_raw, 0.0f) / e.sd;
      const float root = r > 0.0f ? sqrtf(r) : 0.0f;
      g_sig = g_op * root;
      const float g_r = r > 0.0f ? g_op * sig / (2.0f * root) : 0.0f;  // _safe_sqrt: 0 at r <= 0
      g_sd -= g_r * r / e.sd;
      const float g_dr = det_raw >= 0.0f ? g_r / e.sd : 0.0f;  // clamp(min=0) passes at >= 0
      g_cxx += g_dr * dy0;
      g_cyy += g_dr * dx0;
      g_cxy -= 2.0f * e.cxy * g_dr;
    }
    const float g_logit = g_sig * (1.0f - sig) * sig;

    // conic = (c_yy, -c_xy, c_xx) / safe_det
    const float ca = e.cyy / e.sd, cb = -e.cxy / e.sd, cc = e.cxx / e.sd;
    g_cyy += g_a / e.sd;
    g_cxy -= g_b / e.sd;
    g_cxx += g_c / e.sd;
    g_sd -= (g_a * ca + g_b * cb + g_c * cc) / e.sd;
    const float g_det = e.sd_ok ? g_sd : 0.0f;
    g_cxx += g_det * e.cyy;
    g_cyy += g_det * e.cxx;
    g_cxy -= 2.0f * e.cxy * g_det;

    // cov2d = sum_k var_k (u1_k, u2_k)^2: the log-scales and (J W R)
    float d_ls[3], g_u1[3], g_u2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float u1 = e.u1[k], u2 = e.u2[k], v = e.var[k];
      const float g_var = g_cxx * u1 * u1 + g_cxy * u1 * u2 + g_cyy * u2 * u2;
      d_ls[k] = 2.0f * v * g_var;
      g_u1[k] = v * (2.0f * g_cxx * u1 + g_cxy * u2);
      g_u2[k] = v * (2.0f * g_cyy * u2 + g_cxy * u1);
    }
    // u = jw R: the rotation and the Jacobian rows
    float g_rot[3][3], g_jw1[3], g_jw2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_jw1[k] = g_u1[0] * e.rot[k][0] + g_u1[1] * e.rot[k][1] + g_u1[2] * e.rot[k][2];
      g_jw2[k] = g_u2[0] * e.rot[k][0] + g_u2[1] * e.rot[k][1] + g_u2[2] * e.rot[k][2];
#pragma unroll
      for (int j = 0; j < 3; ++j) g_rot[k][j] = g_u1[j] * e.jw1[k] + g_u2[j] * e.jw2[k];
    }
    float g_j11 = 0.0f, g_j13 = 0.0f, g_j22 = 0.0f, g_j23 = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_j11 += g_jw1[k] * c.r[0][k];
      g_j13 += g_jw1[k] * c.r[2][k];
      g_j22 += g_jw2[k] * c.r[1][k];
      g_j23 += g_jw2[k] * c.r[2][k];
    }
    g_j11 -= g_j13 * e.tx;  // j13 = -j11 tx
    g_j22 -= g_j23 * e.ty;
    const float g_tx = -g_j13 * e.j11, g_ty = -g_j23 * e.j22;
    // the frustum clamp: max then min, each passing half at a tie
    const float g_x = g_tx * dmin_da(e.mx, c.clip_r) * dmax_da(e.x, c.clip_l) + g_m2x * c.fx;
    const float g_y = g_ty * dmin_da(e.my, c.clip_b) * dmax_da(e.y, c.clip_t) + g_m2y * c.fy;
    // j11 = fx / sdep, j22 = fy / sdep, x = p0 / sdep, y = p1 / sdep
    const float g_sdep = -(g_j11 * e.j11 + g_j22 * e.j22 + g_x * e.x + g_y * e.y) / e.sdep;
    const float g_p[3] = {g_x / e.sdep, g_y / e.sdep, g_depth + (e.sdep_ok ? g_sdep : 0.0f)};
    float d_m[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      d_m[i] = c.r[0][i] * g_p[0] + c.r[1][i] * g_p[1] + c.r[2][i] * g_p[2];

    // the rotation from the quaternion (quat_to_rotmat)
    const float gxx = -(g_rot[1][1] + g_rot[2][2]), gyy = -(g_rot[0][0] + g_rot[2][2]),
                gzz = -(g_rot[0][0] + g_rot[1][1]);
    const float gxy = g_rot[0][1] + g_rot[1][0], gwz = g_rot[1][0] - g_rot[0][1];
    const float gwy = g_rot[0][2] - g_rot[2][0], gxz = g_rot[0][2] + g_rot[2][0];
    const float gyz = g_rot[1][2] + g_rot[2][1], gwx = g_rot[2][1] - g_rot[1][2];
    const float w = e.w, x = e.qx, y = e.qy, z = e.qz, s = e.s;
    const float g_s = gxx * x * x + gyy * y * y + gzz * z * z + gxy * x * y + gxz * x * z +
                      gyz * y * z + gwx * w * x + gwy * w * y + gwz * w * z;
    // s = 2 / max(|q|^2, 1e-24): the clamp passes at >= 1e-24
    const float g_n = e.nsum >= F(1e-24) ? -g_s * s / clamp_min(e.nsum, F(1e-24)) : 0.0f;
    float d_q[4];
    d_q[0] = s * (gwx * x + gwy * y + gwz * z) + 2.0f * w * g_n;
    d_q[1] = s * (2.0f * gxx * x + gxy * y + gxz * z + gwx * w) + 2.0f * x * g_n;
    d_q[2] = s * (2.0f * gyy * y + gxy * x + gyz * z + gwy * w) + 2.0f * y * g_n;
    d_q[3] = s * (2.0f * gzz * z + gxz * x + gyz * y + gwz * w) + 2.0f * z * g_n;

    // SH: d sh0, d shN into this thread's row, d means through the direction
    if constexpr (kRest > 0) {
      float dir[3];
      const float norm = view_dir(c, m, dir);
      const float nc = clamp_min(norm, F(1e-12));
      const float ux = dvd(dir[0], nc), uy = dvd(dir[1], nc), uz = dvd(dir[2], nc);
      float b[15], gb[15];
      sh_bases(ux, uy, uz, b);
      const int deg = *a.sh_degree;
      const int active_bases = (deg + 1) * (deg + 1);
      float* row = s_sh + threadIdx.x * kRow;
#pragma unroll
      for (int i = 0; i < 15; ++i) gb[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < kRest; ++i) {
        const bool on = i + 1 < active_bases;
        const float bi = on ? b[i] : 0.0f;
        float acc = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          acc += g_col[ch] * row[3 * i + ch];
          row[3 * i + ch] = bi * g_col[ch];  // the row is this thread's alone
        }
        gb[i] = on ? acc : 0.0f;
      }
      float g_u[3];
      sh_bases_grad(ux, uy, uz, gb, g_u);
      // u = dir / max(|dir|, 1e-12); |dir|'s gradient is 0 at 0
      const float g_dot_u = g_u[0] * ux + g_u[1] * uy + g_u[2] * uz;
      const float radial = norm >= F(1e-12) && norm > 0.0f ? g_dot_u / norm : 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) d_m[i] += g_u[i] / nc - radial * dir[i] / nc;
    }

#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a.d_means[3 * g + i] = d_m[i];
      a.d_log_scales[3 * g + i] = d_ls[i];
      a.d_sh0[3 * g + i] = F(kShC0) * g_col[i];
    }
    reinterpret_cast<float4*>(a.d_quats)[g] = make_float4(d_q[0], d_q[1], d_q[2], d_q[3]);
    a.d_logits[g] = g_logit;
  }
  if constexpr (kRow > 0) {  // the block's d shN rows, one contiguous range
    __syncthreads();
    const int n_floats = nb * kRow;
    float* dst = a.d_shN + (size_t)g0 * kRow;
    const int n_vec = n_floats >> 2;
    for (int i = threadIdx.x; i < n_vec; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(s_sh)[i];
    for (int i = 4 * n_vec + threadIdx.x; i < n_floats; i += kThreads) dst[i] = s_sh[i];
  }
}

// span is (tile_size - 1) + 2 dilate_px as the caller rounds it from double
// (the plain path's Python float); 2 dilate_px rounds as 2 (float) dilate_px
Frame make_frame(int width, int height, int tile_size, int cap, float dilate_px, float span,
                 float near_plane, float far_plane) {
  Frame fr;
  fr.clip_x0 = static_cast<float>(-0.15 * width);
  fr.clip_x1 = static_cast<float>(1.15 * width);
  fr.clip_y0 = static_cast<float>(-0.15 * height);
  fr.clip_y1 = static_cast<float>(1.15 * height);
  fr.near_plane = near_plane;
  fr.far_plane = far_plane;
  fr.pad = dilate_px;
  fr.pad2 = 2.0f * dilate_px;
  fr.span = span;
  fr.tile = static_cast<float>(tile_size);
  fr.tile_size = tile_size;
  fr.grid_w = tile_size > 0 ? (width + tile_size - 1) / tile_size : 0;
  fr.grid_h = tile_size > 0 ? (height + tile_size - 1) / tile_size : 0;
  fr.cap = cap;
  return fr;
}

template <int kRest, bool kAA>
void launch_forward(const FwdArgs& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  project_ewa_forward_kernel<kRest, kAA><<<blocks, kThreads, 0, stream>>>(a);
}

template <int kRest, bool kAA>
void launch_backward(const BwdArgs& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  project_ewa_backward_kernel<kRest, kAA><<<blocks, kThreads, 0, stream>>>(a);
}

// the row of an instance table for shN's n_rest (SH degree 0-3); -1 for none
int rest_row(int n_rest) {
  return n_rest == 0 ? 0 : n_rest == 3 ? 1 : n_rest == 8 ? 2 : n_rest == 15 ? 3 : -1;
}

}  // namespace

extern "C" int lfs_project_ewa_forward(
    const void* means, const void* log_scales, const void* quats, const void* logits,
    const void* sh0, const void* shN, const void* active, const void* sh_degree, const void* w2c,
    const void* cam_position, const void* K, int n, int n_rest, int width, int height,
    int tile_size, int exact_tile_cap, int antialiasing, float dilate_px, float span,
    float near_plane, float far_plane, void* depth, void* mean2d, void* conic, void* opacity, void* color,
    void* bbox, void* n_touched, void* valid, void* tile_mask, void* stream) {
  if (tile_size <= 0 || exact_tile_cap > 32 || rest_row(n_rest) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  FwdArgs a;
  a.means = static_cast<const float*>(means);
  a.log_scales = static_cast<const float*>(log_scales);
  a.quats = static_cast<const float*>(quats);
  a.logits = static_cast<const float*>(logits);
  a.sh0 = static_cast<const float*>(sh0);
  a.shN = static_cast<const float*>(shN);
  a.active = static_cast<const uint8_t*>(active);
  a.sh_degree = static_cast<const int*>(sh_degree);
  a.w2c = static_cast<const float*>(w2c);
  a.cam_pos = static_cast<const float*>(cam_position);
  a.k = static_cast<const float*>(K);
  a.n = n;
  a.fr = make_frame(width, height, tile_size, exact_tile_cap, dilate_px, span, near_plane,
                    far_plane);
  a.depth = static_cast<float*>(depth);
  a.mean2d = static_cast<float*>(mean2d);
  a.conic = static_cast<float*>(conic);
  a.opacity = static_cast<float*>(opacity);
  a.color = static_cast<float*>(color);
  a.bbox = static_cast<int4*>(bbox);
  a.n_touched = static_cast<int*>(n_touched);
  a.valid = static_cast<uint8_t*>(valid);
  a.tile_mask = static_cast<int*>(tile_mask);
  static void (*const table[4][2])(const FwdArgs&, cudaStream_t) = {
      {launch_forward<0, false>, launch_forward<0, true>},
      {launch_forward<3, false>, launch_forward<3, true>},
      {launch_forward<8, false>, launch_forward<8, true>},
      {launch_forward<15, false>, launch_forward<15, true>}};
  table[rest_row(n_rest)][antialiasing != 0](a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lfs_project_ewa_backward(
    const void* means, const void* log_scales, const void* quats, const void* logits,
    const void* shN, const void* sh_degree, const void* w2c, const void* cam_position,
    const void* K, int n, int n_rest, int width, int height, int antialiasing,
    const void* g_depth, int s_depth, const void* g_mean2d, int s_mean2d, const void* g_conic,
    int s_conic, const void* g_opacity, int s_opacity, const void* g_color, int s_color,
    void* d_means, void* d_log_scales, void* d_quats, void* d_logits, void* d_sh0, void* d_shN,
    void* stream) {
  if (rest_row(n_rest) < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  BwdArgs a;
  a.means = static_cast<const float*>(means);
  a.log_scales = static_cast<const float*>(log_scales);
  a.quats = static_cast<const float*>(quats);
  a.logits = static_cast<const float*>(logits);
  a.shN = static_cast<const float*>(shN);
  a.sh_degree = static_cast<const int*>(sh_degree);
  a.w2c = static_cast<const float*>(w2c);
  a.cam_pos = static_cast<const float*>(cam_position);
  a.k = static_cast<const float*>(K);
  a.n = n;
  a.fr = make_frame(width, height, 16, 0, 0.0f, 0.0f, 0.0f, 0.0f);  // the clip constants alone
  a.g_depth = static_cast<const float*>(g_depth);
  a.g_mean2d = static_cast<const float*>(g_mean2d);
  a.g_conic = static_cast<const float*>(g_conic);
  a.g_opacity = static_cast<const float*>(g_opacity);
  a.g_color = static_cast<const float*>(g_color);
  a.s_depth = s_depth;
  a.s_mean2d = s_mean2d;
  a.s_conic = s_conic;
  a.s_opacity = s_opacity;
  a.s_color = s_color;
  a.d_means = static_cast<float*>(d_means);
  a.d_log_scales = static_cast<float*>(d_log_scales);
  a.d_quats = static_cast<float*>(d_quats);
  a.d_logits = static_cast<float*>(d_logits);
  a.d_sh0 = static_cast<float*>(d_sh0);
  a.d_shN = static_cast<float*>(d_shN);
  static void (*const table[4][2])(const BwdArgs&, cudaStream_t) = {
      {launch_backward<0, false>, launch_backward<0, true>},
      {launch_backward<3, false>, launch_backward<3, true>},
      {launch_backward<8, false>, launch_backward<8, true>},
      {launch_backward<15, false>, launch_backward<15, true>}};
  table[rest_row(n_rest)][antialiasing != 0](a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
