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
// kernel (sum3_last, sum4_last, sum_rows in project_common.cuh). So valid,
// bbox, n_touched and tile_mask equal the plain path's bit for bit, and so
// do depth, mean2d, conic, opacity and the SH colour (its direction norm
// summed as torch.linalg.norm sums it). The backward is the closed form of
// the plain path's autograd, in plain float arithmetic (contraction allowed).
//
// What this file shares with the UT projection (project_ut.cu) lives in
// project_common.cuh: the rounding helpers, the rotation, the tile bounds and
// the exact tile test, the SH colour and its backward, the shN staging.

#include "project_common.cuh"

namespace {

constexpr double kDilation = 0.3;

// --- the camera ----------------------------------------------------------------

struct EwaCamera : Camera {
  float clip_l, clip_r, clip_t, clip_b;  // the 15 %-expanded frustum in normalised coordinates
};

__device__ __forceinline__ EwaCamera load_ewa_camera(const float* __restrict__ w2c,
                                                     const float* __restrict__ k,
                                                     const float* __restrict__ cam_pos,
                                                     const Frame& fr) {
  EwaCamera c;
  static_cast<Camera&>(c) = load_camera(w2c, k, cam_pos);
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

__device__ __forceinline__ void ewa(const EwaCamera& c, const float m[3], const float ls[3],
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
  e.w = q[0];
  e.qx = q[1];
  e.qy = q[2];
  e.qz = q[3];
  quat_rotation(q, e.rot, e.nsum, e.s);
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

template <int kRest, bool kAA>
__global__ void __launch_bounds__(kThreads) project_ewa_forward_kernel(FwdArgs a) {
  constexpr int kRow = 3 * kRest;
  __shared__ __align__(16) float s_sh[kRow > 0 ? kThreads * kRow : 4];
  const int g0 = blockIdx.x * kThreads;
  if constexpr (kRow > 0) stage_rows(s_sh, a.shN + (size_t)g0 * kRow, min(kThreads, a.n - g0) * kRow);
  const int g = g0 + threadIdx.x;
  if (g >= a.n) return;
  const Frame& fr = a.fr;
  const EwaCamera c = load_ewa_camera(a.w2c, a.k, a.cam_pos, fr);

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
  const Bounds b = screen_bounds(m2x, m2y, ca, cb, cc, e.cxx, e.cyy, op, valid, fr);
  float col[3];
  sh_color<kRest>(c, m, a.sh0 + 3 * g, s_sh + threadIdx.x * kRow, *a.sh_degree, col);

  a.depth[g] = depth;
  reinterpret_cast<float2*>(a.mean2d)[g] = make_float2(m2x, m2y);
  a.conic[3 * g + 0] = ca;
  a.conic[3 * g + 1] = cb;
  a.conic[3 * g + 2] = cc;
  a.opacity[g] = op;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) a.color[3 * g + ch] = col[ch];
  a.bbox[g] = make_int4(b.x_min, b.x_max, b.y_min, b.y_max);
  a.n_touched[g] = b.n_touched;
  a.valid[g] = valid ? 1 : 0;
  a.tile_mask[g] = static_cast<int>(b.mask);
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
    const EwaCamera c = load_ewa_camera(a.w2c, a.k, a.cam_pos, a.fr);
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

    // SH: d shN into this thread's row, d means through the direction
    sh_color_backward<kRest>(c, m, s_sh + threadIdx.x * kRow, *a.sh_degree, g_col, d_m);

#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a.d_means[3 * g + i] = d_m[i];
      a.d_log_scales[3 * g + i] = d_ls[i];
      a.d_sh0[3 * g + i] = F(kShC0) * g_col[i];
    }
    reinterpret_cast<float4*>(a.d_quats)[g] = make_float4(d_q[0], d_q[1], d_q[2], d_q[3]);
    a.d_logits[g] = g_logit;
  }
  if constexpr (kRow > 0) store_rows(a.d_shN + (size_t)g0 * kRow, s_sh, nb * kRow);
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
