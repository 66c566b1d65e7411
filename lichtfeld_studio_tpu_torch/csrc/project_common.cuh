// What the EWA projection (project_ewa.cu) and the UT projection
// (project_ut.cu) share: float32 rounded as the plain path rounds it on the
// card, the camera, the gaussian's rotation, the conservative tile bounds and
// the exact tile test, the SH colour and its backward, and shN staged through
// shared memory. Each kernel is one thread a gaussian in blocks of kThreads;
// project_ewa.cu's header says why each piece is written as it is.

#pragma once

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

// --- the camera and the tile grid ---------------------------------------------

struct Frame {  // host-side scalars, rounded to float32 as torch rounds Python floats
  float clip_x0, clip_x1, clip_y0, clip_y1;  // the EWA frustum: -0.15 W, 1.15 W, -0.15 H, 1.15 H
  float near_plane, far_plane;
  float pad, pad2, span;  // dilate_px, 2 dilate_px, (tile - 1) + 2 dilate_px
  float tile;
  int grid_w, grid_h, tile_size, cap;
};

// span is (tile_size - 1) + 2 dilate_px as the caller rounds it from double
// (the plain path's Python float); 2 dilate_px rounds as 2 (float) dilate_px
inline Frame make_frame(int width, int height, int tile_size, int cap, float dilate_px, float span,
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

struct Camera {
  float r[3][3], t[3];  // world to camera
  float fx, fy, cx, cy;
  float pos[3];
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ w2c,
                                              const float* __restrict__ k,
                                              const float* __restrict__ cam_pos) {
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
  return c;
}

// the camera-space point: explicit component sums, as the plain paths write them
__device__ __forceinline__ void camera_point(const Camera& c, const float m[3], float p[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = add(add(add(mul(m[0], c.r[i][0]), mul(m[1], c.r[i][1])), mul(m[2], c.r[i][2])), c.t[i]);
}

// quat_to_rotmat (ops/gaussians.py): the rotation, |q|^2 as it sums it and
// s = 2 / max(|q|^2, 1e-24)
__device__ __forceinline__ void quat_rotation(const float q[4], float rot[3][3], float& nsum,
                                              float& s) {
  const float w = q[0], qx = q[1], qy = q[2], qz = q[3];
  nsum = add(add(add(mul(w, w), mul(qx, qx)), mul(qy, qy)), mul(qz, qz));
  s = dvd(2.0f, clamp_min(nsum, F(1e-24)));
  const float sx = mul(s, qx), sy = mul(s, qy), sz = mul(s, qz), sw = mul(s, w);
  const float xx = mul(sx, qx), yy = mul(sy, qy), zz = mul(sz, qz);
  const float xy = mul(sx, qy), xz = mul(sx, qz), yz = mul(sy, qz);
  const float wx = mul(sw, qx), wy = mul(sw, qy), wz = mul(sw, qz);
  rot[0][0] = sub(1.0f, add(yy, zz));
  rot[0][1] = sub(xy, wz);
  rot[0][2] = add(wy, xz);
  rot[1][0] = add(wz, xy);
  rot[1][1] = sub(1.0f, add(xx, zz));
  rot[1][2] = sub(yz, wx);
  rot[2][0] = sub(xz, wy);
  rot[2][1] = add(wx, yz);
  rot[2][2] = sub(1.0f, add(xx, yy));
}

__device__ __forceinline__ float sigmoid(float v) { return dvd(1.0f, add(1.0f, expf(-v))); }

// --- conservative tile bounds and the exact tile test (ops/projection.py) ----------

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

struct Bounds {
  int x_min, x_max, y_min, y_max, n_touched;
  unsigned mask;
};

// ops/projection.py::screen_bounds for one gaussian: the bbox from the
// extents, then the exact test over its cells where fr.cap > 0 and the bbox
// has at most fr.cap of them; clears `valid` as it does
__device__ __forceinline__ Bounds screen_bounds(float m2x, float m2y, float ca, float cb, float cc,
                                                float cxx, float cyy, float op, bool& valid,
                                                const Frame& fr) {
  Bounds b;
  const float power_threshold = logf(mul(clamp_min(op, F(kAlphaMin)), F(kAlphaMinRcp)));
  const float ptf = sqrtf(clamp_min(mul(2.0f, power_threshold), 0.0f));
  const float ext_x = add(clamp_min(sub(mul(ptf, sqrtf(clamp_min(cxx, 0.0f))), 0.5f), 0.0f), fr.pad);
  const float ext_y = add(clamp_min(sub(mul(ptf, sqrtf(clamp_min(cyy, 0.0f))), 0.5f), 0.0f), fr.pad);
  b.x_min = tile_index(floorf(dvd(sub(m2x, ext_x), fr.tile)), fr.grid_w);
  b.x_max = tile_index(ceilf(dvd(add(m2x, ext_x), fr.tile)), fr.grid_w);
  b.y_min = tile_index(floorf(dvd(sub(m2y, ext_y), fr.tile)), fr.grid_h);
  b.y_max = tile_index(ceilf(dvd(add(m2y, ext_y), fr.tile)), fr.grid_h);
  const int bb_w = b.x_max - b.x_min;
  const int area = bb_w * (b.y_max - b.y_min);
  valid &= area > 0;
  b.n_touched = area;
  b.mask = 0u;
  if (fr.cap > 0 && valid && area <= fr.cap) {  // the exact test over the bbox's cells
    const float mxh = sub(m2x, 0.5f), myh = sub(m2y, 0.5f);
    b.n_touched = 0;
    for (int k = 0; k < area; ++k) {
      if (will_contribute(mxh, myh, ca, cb, cc, b.x_min + k % bb_w, b.y_min + k / bb_w,
                          power_threshold, fr)) {
        b.mask |= 1u << k;
        ++b.n_touched;
      }
    }
    valid &= b.n_touched > 0;
  }
  if (!valid) {
    b.n_touched = 0;
    b.mask = 0u;
  }
  return b;
}

// --- SH colour (ops/sh.py::sh_to_color) ------------------------------------------

// the unnormalised view direction and its norm
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

// the colour at the active degree: row is this gaussian's shN row (kRest x 3)
template <int kRest>
__device__ __forceinline__ void sh_color(const Camera& c, const float m[3],
                                         const float* __restrict__ sh0, const float* row, int deg,
                                         float col[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) col[ch] = add(0.5f, mul(F(kShC0), sh0[ch]));
  if constexpr (kRest > 0) {
    float dir[3];
    const float nc = clamp_min(view_dir(c, m, dir), F(1e-12));
    float b[15];
    sh_bases(dvd(dir[0], nc), dvd(dir[1], nc), dvd(dir[2], nc), b);
    const int active_bases = (deg + 1) * (deg + 1);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float t[kRest];
#pragma unroll
      for (int i = 0; i < kRest; ++i)
        t[i] = mul(mul(b[i], i + 1 < active_bases ? 1.0f : 0.0f), row[3 * i + ch]);
      col[ch] = add(col[ch], sum_rows<kRest>(t));
    }
  }
}

// The colour's backward: d shN written over this gaussian's row (the row is
// the thread's alone), and d means through the view direction added to d_m
template <int kRest>
__device__ __forceinline__ void sh_color_backward(const Camera& c, const float m[3], float* row,
                                                  int deg, const float g_col[3], float d_m[3]) {
  if constexpr (kRest > 0) {
    float dir[3];
    const float norm = view_dir(c, m, dir);
    const float nc = clamp_min(norm, F(1e-12));
    const float ux = dvd(dir[0], nc), uy = dvd(dir[1], nc), uz = dvd(dir[2], nc);
    float b[15], gb[15];
    sh_bases(ux, uy, uz, b);
    const int active_bases = (deg + 1) * (deg + 1);
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
        row[3 * i + ch] = bi * g_col[ch];
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

// The block's rows back to dst (16-byte aligned), one contiguous range, in
// coalesced 16-byte stores; every thread of the block calls it
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* s, int n_floats) {
  __syncthreads();
  const int n_vec = n_floats >> 2;
  for (int i = threadIdx.x; i < n_vec; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(s)[i];
  for (int i = 4 * n_vec + threadIdx.x; i < n_floats; i += kThreads) dst[i] = s[i];
}

// the outputs' gradients: null reads 0, rows `stride` floats apart
__device__ __forceinline__ float grad_in(const float* p, int stride, int g, int j) {
  return p != nullptr ? p[(size_t)g * stride + j] : 0.0f;
}

// the row of an instance table for shN's n_rest (SH degree 0-3); -1 for none
inline int rest_row(int n_rest) {
  return n_rest == 0 ? 0 : n_rest == 3 ? 1 : n_rest == 8 ? 2 : n_rest == 15 ? 3 : -1;
}

}  // namespace
