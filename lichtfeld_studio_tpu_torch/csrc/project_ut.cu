// UT projection with SH colour: one forward and one backward kernel.
//
// Replaces no TPU kernel: the JAX package leaves the unscented-transform
// projection (lichtfeld_studio_tpu/ops/ut_projection.py, ops/sh.py) to XLA,
// which fuses it. Its plain PyTorch form (lichtfeld_studio_tpu_torch/ops/
// ut_projection.py) works on [C, 7, 3] sigma-point tensors: several hundred
// elementwise launches, stacks and concatenations a view, each writing its
// [C, 7, .] intermediate to device memory and keeping it for autograd. The
// shape of the two kernels is the upstream's fused 3DGUT projection
// (gsplat ProjectionUT3DGSFused.cu:16-289), one thread per gaussian.
//
// What bounds them on the H100: device-memory traffic alone. The forward
// reads the 59 floats of a gaussian (means, log-scales, quaternion, logit,
// sh0, shN) and a live flag, and writes the 16 words of ProjectedSplats
// (~300 B a gaussian, ~0.09 ms at 1M and 3.35 TB/s); seven sigma points
// through the camera model are a few hundred float operations, a tenth of
// that at 67 TFLOP/s. The backward takes only the gradients of the colour,
// the opacity and the depth: the routes that take these kernels (ops/
// rasterize.py::_project) are those where mean2d and conic feed nothing
// that is differentiated (the exact world-space blend reads the gaussians
// themselves; an inference render differentiates nothing). So it reads the
// means, the logit, shN and 7 floats of gradients, and writes d means, d
// logit, d sh0 and d shN (~420 B, ~0.13 ms); the log-scales and the
// quaternion get no gradient through these outputs. Design, as in
// project_ewa.cu: nothing is saved between the two kernels; shN is staged
// through shared memory in coalesced 16-byte cp.async copies and d shN
// stored from there; the exact tile test runs in registers; the active SH
// degree is read from its device scalar.
//
// Rounding. As in project_ewa.cu, every operation of the forward is a
// separately rounded __f*_rn intrinsic in the plain path's order, expf,
// atan2f and sqrtf are the library calls PyTorch's kernels call, clamps
// propagate NaN as torch's do, and Python floats reach the kernel rounded to
// float32 as torch rounds them (the wrapper computes the UT weights and the
// in-image margins as the plain path does). The weighted sums over the seven
// points run first to last as ops/ut_projection.py::_ordered_sum adds them
// (w_mean[0] is -99 and cancels against the other six, so the order shows).
// So valid, bbox, n_touched, tile_mask, depth, mean2d, conic, opacity and
// colour equal the plain path's bit for bit on the card. Global shutter only:
// a rolling shutter's per-point pose fixed point stays on the plain path.

#include "project_common.cuh"

namespace {

// core/camera.py::CameraModelType
constexpr int kPinhole = 0, kOpenCV = 1, kFisheye = 2, kOrtho = 3;
constexpr int kPoints = 7;  // sigma points a gaussian

struct UtConsts {  // host-side scalars, rounded to float32 as torch rounds Python floats
  float lo_u, hi_u, lo_v, hi_v;  // the in-image margins: -0.1 W, 1.1 W, -0.1 H, 1.1 H
  float delta;                   // sqrt(D + lambda)
  float wm0, wm1, wc0, wc1;      // w_mean[0], w_mean[1..6], w_cov[0], w_cov[1..6]
  float eps2d;
};

// ops/ut_projection.py::_project_points for one camera-space point: the
// image point, and whether it is in front of the camera and in the image
template <int kModel>
__device__ __forceinline__ bool project_point(const Camera& c, const float p[3],
                                              const float d[8], const UtConsts& u, float& px,
                                              float& py) {
  const float z = p[2];
  float x, y;
  bool valid_z;
  if constexpr (kModel == kOrtho) {
    x = p[0];
    y = p[1];
    valid_z = z > 0.0f;
  } else if constexpr (kModel == kFisheye) {  // equidistant, theta polynomial k1..k4
    const float r = sqrtf(add(mul(p[0], p[0]), mul(p[1], p[1])));
    const float theta = atan2f(r, z);
    const float t2 = mul(theta, theta);
    const float theta_d =
        mul(theta, add(1.0f, mul(t2, add(d[0], mul(t2, add(d[1], mul(t2, add(d[2], mul(t2, d[3])))))))));
    const float scale = r > F(1e-8) ? dvd(theta_d, clamp_min(r, F(1e-8))) : 1.0f;
    x = mul(p[0], scale);
    y = mul(p[1], scale);
    valid_z = z > F(1e-8);
  } else {
    const float sz = fabsf(z) > F(1e-8) ? z : F(1e-8);
    x = dvd(p[0], sz);
    y = dvd(p[1], sz);
    if constexpr (kModel == kOpenCV) {  // rational radial k1..k6, tangential p1 p2
      const float r2 = add(mul(x, x), mul(y, y));
      const float alpha = add(1.0f, mul(r2, add(d[0], mul(r2, add(d[1], mul(r2, d[2]))))));
      const float beta = add(1.0f, mul(r2, add(d[3], mul(r2, add(d[4], mul(r2, d[5]))))));
      const float dd = dvd(alpha, beta);
      const float xd = add(add(mul(x, dd), mul(mul(mul(2.0f, d[6]), x), y)),
                           mul(d[7], add(r2, mul(mul(2.0f, x), x))));
      const float yd = add(add(mul(y, dd), mul(d[6], add(r2, mul(mul(2.0f, y), y)))),
                           mul(mul(mul(2.0f, d[7]), x), y));
      x = xd;
      y = yd;
    }
    valid_z = z > 0.0f;
  }
  px = add(mul(x, c.fx), c.cx);
  py = add(mul(y, c.fy), c.cy);
  return valid_z && px >= u.lo_u && px <= u.hi_u && py >= u.lo_v && py <= u.hi_v;
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
  const float* dist;  // OPENCV: k1..k6, p1, p2; FISHEYE: k1..k4; null for the others
  int n;
  Frame fr;
  UtConsts u;
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

template <int kModel, int kRest>
__global__ void __launch_bounds__(kThreads) project_ut_forward_kernel(FwdArgs a) {
  constexpr int kRow = 3 * kRest;
  __shared__ __align__(16) float s_sh[kRow > 0 ? kThreads * kRow : 4];
  const int g0 = blockIdx.x * kThreads;
  if constexpr (kRow > 0) stage_rows(s_sh, a.shN + (size_t)g0 * kRow, min(kThreads, a.n - g0) * kRow);
  const int g = g0 + threadIdx.x;
  if (g >= a.n) return;
  const Frame& fr = a.fr;
  const UtConsts& u = a.u;
  const Camera c = load_camera(a.w2c, a.k, a.cam_pos);
  float d[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kModel == kOpenCV) {
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = a.dist[i];
  } else if constexpr (kModel == kFisheye) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = a.dist[i];
  }

  float m[3], ls[3], q[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[i] = a.means[3 * g + i];
    ls[i] = a.log_scales[3 * g + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = a.quats[4 * g + i];

  // the depth cull at the mean
  float pm[3];
  camera_point(c, m, pm);
  const float depth = pm[2];
  bool valid = a.active[g] != 0 && depth >= fr.near_plane && depth <= fr.far_plane;
  const float sig = sigmoid(a.logits[g]);
  valid &= sig >= F(kAlphaMin);
  valid &= sum4_last(mul(q[0], q[0]), mul(q[1], q[1]), mul(q[2], q[2]), mul(q[3], q[3])) >= F(1e-8);

  // the sigma points m, m + delta_k, m - delta_k with delta_k = sqrt(D + lambda) s_k R[:, k]
  float rot[3][3], nsum, s;
  quat_rotation(q, rot, nsum, s);
  float delta[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float sk = mul(u.delta, expf(ls[k]));
#pragma unroll
    for (int i = 0; i < 3; ++i) delta[k][i] = mul(sk, rot[i][k]);
  }
  float px[kPoints], py[kPoints];
  bool all_in = true;
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    float pt[3], pc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      pt[i] = j == 0 ? m[i] : j < 4 ? add(m[i], delta[j - 1][i]) : sub(m[i], delta[j - 4][i]);
    camera_point(c, pt, pc);
    all_in &= project_point<kModel>(c, pc, d, u, px[j], py[j]);
  }
  valid &= all_in;  // require_all_sigma_points_valid

  // the weighted mean and covariance, summed first to last
  float m2x = mul(u.wm0, px[0]), m2y = mul(u.wm0, py[0]);
#pragma unroll
  for (int j = 1; j < kPoints; ++j) {
    m2x = add(m2x, mul(u.wm1, px[j]));
    m2y = add(m2y, mul(u.wm1, py[j]));
  }
  float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const float w = j == 0 ? u.wc0 : u.wc1;
    const float dx = sub(px[j], m2x), dy = sub(py[j], m2y);
    const float txx = mul(w, mul(dx, dx)), txy = mul(w, mul(dx, dy)), tyy = mul(w, mul(dy, dy));
    sxx = j == 0 ? txx : add(sxx, txx);
    sxy = j == 0 ? txy : add(sxy, txy);
    syy = j == 0 ? tyy : add(syy, tyy);
  }
  const float cxx = add(sxx, u.eps2d), cxy = sxy, cyy = add(syy, u.eps2d);
  const float det = sub(mul(cxx, cyy), mul(cxy, cxy));
  valid &= det >= F(1e-8);
  const float sd = fabsf(det) > F(1e-12) ? det : F(1e-12);
  const float ca = dvd(cyy, sd), cb = dvd(-cxy, sd), cc = dvd(cxx, sd);

  const Bounds b = screen_bounds(m2x, m2y, ca, cb, cc, cxx, cyy, sig, valid, fr);
  float col[3];
  sh_color<kRest>(c, m, a.sh0 + 3 * g, s_sh + threadIdx.x * kRow, *a.sh_degree, col);

  a.depth[g] = depth;
  reinterpret_cast<float2*>(a.mean2d)[g] = make_float2(m2x, m2y);
  a.conic[3 * g + 0] = ca;
  a.conic[3 * g + 1] = cb;
  a.conic[3 * g + 2] = cc;
  a.opacity[g] = sig;
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
  const float* logits;
  const float* shN;  // [n, kRest, 3], 16-byte aligned
  const int* sh_degree;
  const float* w2c;
  const float* cam_pos;
  int n;
  // the outputs' gradients, each a row stride (floats) apart; null reads 0
  const float* g_depth;
  const float* g_opacity;
  const float* g_color;
  int s_depth, s_opacity, s_color;
  float* d_means;
  float* d_logits;
  float* d_sh0;
  float* d_shN;  // [n, kRest, 3], 16-byte aligned
};

template <int kRest>
__global__ void __launch_bounds__(kThreads) project_ut_backward_kernel(BwdArgs a) {
  constexpr int kRow = 3 * kRest;
  __shared__ __align__(16) float s_sh[kRow > 0 ? kThreads * kRow : 4];
  const int g0 = blockIdx.x * kThreads;
  const int nb = min(kThreads, a.n - g0);
  if constexpr (kRow > 0) stage_rows(s_sh, a.shN + (size_t)g0 * kRow, nb * kRow);
  const int g = g0 + threadIdx.x;
  if (g < a.n) {
    Camera c;  // the view direction's origin and the depth row alone
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      c.r[2][i] = a.w2c[8 + i];
      c.pos[i] = a.cam_pos[i];
    }
    float m[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) m[i] = a.means[3 * g + i];
    const float sig = sigmoid(a.logits[g]);
    const float g_depth = grad_in(a.g_depth, a.s_depth, g, 0);
    const float g_op = grad_in(a.g_opacity, a.s_opacity, g, 0);
    float g_col[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) g_col[ch] = grad_in(a.g_color, a.s_color, g, ch);

    // depth = (R m + t)_z
    float d_m[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) d_m[i] = g_depth * c.r[2][i];
    // the colour: d shN into this thread's row, d means through the direction
    sh_color_backward<kRest>(c, m, s_sh + threadIdx.x * kRow, *a.sh_degree, g_col, d_m);

#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a.d_means[3 * g + i] = d_m[i];
      a.d_sh0[3 * g + i] = F(kShC0) * g_col[i];
    }
    a.d_logits[g] = g_op * (1.0f - sig) * sig;
  }
  if constexpr (kRow > 0) store_rows(a.d_shN + (size_t)g0 * kRow, s_sh, nb * kRow);
}

template <int kModel, int kRest>
void launch_forward(const FwdArgs& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  project_ut_forward_kernel<kModel, kRest><<<blocks, kThreads, 0, stream>>>(a);
}

template <int kRest>
void launch_backward(const BwdArgs& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  project_ut_backward_kernel<kRest><<<blocks, kThreads, 0, stream>>>(a);
}

}  // namespace

extern "C" int lfs_project_ut_forward(
    const void* means, const void* log_scales, const void* quats, const void* logits,
    const void* sh0, const void* shN, const void* active, const void* sh_degree, const void* w2c,
    const void* cam_position, const void* K, const void* dist, int n, int n_rest, int width,
    int height, int tile_size, int camera_model, int exact_tile_cap, float lo_u, float hi_u,
    float lo_v, float hi_v, float delta, float wm0, float wm1, float wc0, float wc1, float eps2d,
    float span, float near_plane, float far_plane, void* depth, void* mean2d, void* conic,
    void* opacity, void* color, void* bbox, void* n_touched, void* valid, void* tile_mask,
    void* stream) {
  if (tile_size <= 0 || exact_tile_cap > 32 || camera_model < kPinhole || camera_model > kOrtho ||
      rest_row(n_rest) < 0 ||
      ((camera_model == kOpenCV || camera_model == kFisheye) && dist == nullptr))
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
  a.dist = static_cast<const float*>(dist);
  a.n = n;
  a.fr = make_frame(width, height, tile_size, exact_tile_cap, 0.0f, span, near_plane, far_plane);
  a.u = UtConsts{lo_u, hi_u, lo_v, hi_v, delta, wm0, wm1, wc0, wc1, eps2d};
  a.depth = static_cast<float*>(depth);
  a.mean2d = static_cast<float*>(mean2d);
  a.conic = static_cast<float*>(conic);
  a.opacity = static_cast<float*>(opacity);
  a.color = static_cast<float*>(color);
  a.bbox = static_cast<int4*>(bbox);
  a.n_touched = static_cast<int*>(n_touched);
  a.valid = static_cast<uint8_t*>(valid);
  a.tile_mask = static_cast<int*>(tile_mask);
  static void (*const table[4][4])(const FwdArgs&, cudaStream_t) = {
      {launch_forward<kPinhole, 0>, launch_forward<kPinhole, 3>, launch_forward<kPinhole, 8>,
       launch_forward<kPinhole, 15>},
      {launch_forward<kOpenCV, 0>, launch_forward<kOpenCV, 3>, launch_forward<kOpenCV, 8>,
       launch_forward<kOpenCV, 15>},
      {launch_forward<kFisheye, 0>, launch_forward<kFisheye, 3>, launch_forward<kFisheye, 8>,
       launch_forward<kFisheye, 15>},
      {launch_forward<kOrtho, 0>, launch_forward<kOrtho, 3>, launch_forward<kOrtho, 8>,
       launch_forward<kOrtho, 15>}};
  table[camera_model][rest_row(n_rest)](a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lfs_project_ut_backward(
    const void* means, const void* logits, const void* shN, const void* sh_degree,
    const void* w2c, const void* cam_position, int n, int n_rest, const void* g_depth,
    int s_depth, const void* g_opacity, int s_opacity, const void* g_color, int s_color,
    void* d_means, void* d_logits, void* d_sh0, void* d_shN, void* stream) {
  if (rest_row(n_rest) < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  BwdArgs a;
  a.means = static_cast<const float*>(means);
  a.logits = static_cast<const float*>(logits);
  a.shN = static_cast<const float*>(shN);
  a.sh_degree = static_cast<const int*>(sh_degree);
  a.w2c = static_cast<const float*>(w2c);
  a.cam_pos = static_cast<const float*>(cam_position);
  a.n = n;
  a.g_depth = static_cast<const float*>(g_depth);
  a.g_opacity = static_cast<const float*>(g_opacity);
  a.g_color = static_cast<const float*>(g_color);
  a.s_depth = s_depth;
  a.s_opacity = s_opacity;
  a.s_color = s_color;
  a.d_means = static_cast<float*>(d_means);
  a.d_logits = static_cast<float*>(d_logits);
  a.d_sh0 = static_cast<float*>(d_sh0);
  a.d_shN = static_cast<float*>(d_shN);
  static void (*const table[4])(const BwdArgs&, cudaStream_t) = {
      launch_backward<0>, launch_backward<3>, launch_backward<8>, launch_backward<15>};
  table[rest_row(n_rest)](a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
