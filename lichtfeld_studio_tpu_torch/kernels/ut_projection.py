"""UT projection with SH colour as two hand-written CUDA kernels
(csrc/project_ut.cu: lfs_project_ut_forward, lfs_project_ut_backward),
bound as one autograd Function.

Replaces no TPU kernel: the JAX package leaves the unscented-transform
projection (lichtfeld_studio_tpu/ops/ut_projection.py, ops/sh.py) to XLA,
which fuses it; its plain PyTorch form (ops/ut_projection.py::
project_gaussians_ut) works on [C, 7, 3] sigma-point tensors, several
hundred elementwise launches whose intermediates autograd keeps. Both
kernels are bound by device-memory bytes (~300 B a gaussian forward, ~420 B
backward): one thread a gaussian, shN through shared memory in coalesced
16-byte pieces, the seven sigma points in registers, nothing saved between
the two (the csrc file's header says more, and how the outputs come out
bit-equal to the plain path's).

The backward takes the gradients of the colour, the opacity and the depth
alone: d mean2d and d conic are not computed, so the log-scales and the
quaternion get none. That is all a caller may differentiate where mean2d
and conic feed nothing differentiable: the exact world-space blend, which
reads the gaussians themselves, and an inference render.

Routing (`ut_kernel_route`): CUDA tensors, a camera that needs no gradient,
a global shutter, no antialiasing, and no gradient asked of mean2d and
conic (`screen_grad` False: ops/rasterize.py passes it). Everything else
keeps project_gaussians_ut: the 2D blend's training path (its P3 gradient
reaches mean2d and conic), rolling shutters (the per-point pose fixed
point), antialiasing (its compensation carries d opacity into the
covariance), pose optimisation, and CPU tensors. On CPU tensors the
Function itself runs the kernels' plain versions: project_gaussians_ut
under no_grad forward, project_ut_backward_plain backward.
"""

from __future__ import annotations

import functools

import torch

from lichtfeld_studio_tpu_torch.core.camera import CameraModelType
from lichtfeld_studio_tpu_torch.kernels import _build
from lichtfeld_studio_tpu_torch.kernels.projection import (
    SH_RESTS,
    _aligned16,
    _check_inputs,
    _degree_tensor,
    _grad_pointers,
    _on_cuda,
    kernel_route,
    sh_backward_plain,
)
from lichtfeld_studio_tpu_torch.ops.projection import (
    EXACT_TILE_CAP,
    FAR_PLANE,
    NEAR_PLANE,
    ProjectedSplats,
)
from lichtfeld_studio_tpu_torch.ops.ut_projection import (
    EPS2D,
    UT_MARGIN,
    _coeffs,
    project_gaussians_ut,
    ut_weights,
)
from lichtfeld_studio_tpu_torch.profiling import stage


def ut_kernel_route(means: torch.Tensor, w2c: torch.Tensor, cam_position: torch.Tensor,
                    K: torch.Tensor, *, rolling: bool, antialiasing: bool,
                    screen_grad: bool) -> bool:
    """True where the UT projection takes the kernels (module docstring)."""
    return (kernel_route(means, w2c, cam_position, K) and not rolling and not antialiasing
            and not screen_grad)


def _distortion(camera_model: int, radial, tangential, device) -> torch.Tensor | None:
    """The coefficients the forward kernel reads: OPENCV_PINHOLE's radial
    k1..k6 and tangential p1, p2, OPENCV_FISHEYE's k1..k4, each zero-padded
    as the plain path pads them; None for the models that take none."""
    if camera_model == CameraModelType.OPENCV_PINHOLE:
        return torch.cat([_coeffs(radial, 6, device), _coeffs(tangential, 2, device)])
    if camera_model == CameraModelType.OPENCV_FISHEYE:
        return _coeffs(radial, 4, device)
    return None


@functools.cache
def _ut_constants() -> tuple[float, ...]:
    """sqrt(D + lambda), w_mean[0], w_mean[1..6], w_cov[0], w_cov[1..6] as
    the plain path computes them (ops/ut_projection.py::ut_weights)."""
    delta, w_mean, w_cov = ut_weights("cpu")
    return (delta, *w_mean.tolist()[:2], *w_cov.tolist()[:2])


# --- the forward --------------------------------------------------------------------

def project_ut_forward(means, log_scales, quats, logit_opacities, sh0, shN, active_mask,
                       active_sh_degree, w2c, cam_position, K, *, width: int, height: int,
                       tile_size: int = 16, camera_model: int = CameraModelType.PINHOLE,
                       radial: torch.Tensor | None = None,
                       tangential: torch.Tensor | None = None, near: float = NEAR_PLANE,
                       far: float = FAR_PLANE, exact_tile_test: bool = True) -> ProjectedSplats:
    """project_gaussians_ut's outputs at a global shutter without
    antialiasing, with no autograd graph: the forward kernel for CUDA
    tensors, the plain path for CPU tensors."""
    logits = logit_opacities.reshape(-1)
    _check_inputs("project_ut_forward", means, log_scales, quats, logits, sh0, shN, w2c,
                  cam_position, K)
    if not _on_cuda(means):
        with torch.no_grad():
            return project_gaussians_ut(
                means, log_scales, quats, logits, sh0, shN, active_mask, active_sh_degree, w2c,
                cam_position, K, width=width, height=height, tile_size=tile_size,
                camera_model=camera_model, radial=radial, tangential=tangential, near=near,
                far=far, exact_tile_test=exact_tile_test)
    if active_mask.dtype != torch.bool or tuple(active_mask.shape) != (means.shape[0],):
        raise ValueError(f"project_ut_forward: active_mask must be bool [C], got "
                         f"{active_mask.dtype} {tuple(active_mask.shape)}")
    dev, n = means.device, means.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    out = ProjectedSplats(
        depth=torch.empty(n, **f32), mean2d=torch.empty((n, 2), **f32),
        conic=torch.empty((n, 3), **f32), opacity=torch.empty(n, **f32),
        color=torch.empty((n, 3), **f32),
        bbox=torch.empty((n, 4), dtype=torch.int32, device=dev),
        n_touched=torch.empty(n, dtype=torch.int32, device=dev),
        valid=torch.empty(n, dtype=torch.bool, device=dev),
        tile_mask=torch.empty(n, dtype=torch.int32, device=dev))
    dist = _distortion(camera_model, radial, tangential, dev)
    delta, wm0, wm1, wc0, wc1 = _ut_constants()
    ins = [t.contiguous() for t in (means, log_scales, quats, logits, sh0)]
    err = _build.load_library().lfs_project_ut_forward(
        *(t.data_ptr() for t in ins), _aligned16(shN).data_ptr(),
        active_mask.contiguous().data_ptr(), _degree_tensor(active_sh_degree, dev).data_ptr(),
        *(t.contiguous().data_ptr() for t in (w2c, cam_position, K)),
        None if dist is None else dist.data_ptr(),
        # the exact tile test over screen_bounds' default cap, or none (the bbox)
        n, shN.shape[1], width, height, tile_size, int(camera_model),
        EXACT_TILE_CAP if exact_tile_test else 0,
        # float32 as torch rounds the plain path's Python floats
        -UT_MARGIN * width, (1 + UT_MARGIN) * width, -UT_MARGIN * height,
        (1 + UT_MARGIN) * height, delta, wm0, wm1, wc0, wc1, EPS2D,
        float(tile_size - 1), near, far,
        *(t.data_ptr() for t in (out.depth, out.mean2d, out.conic, out.opacity, out.color,
                                 out.bbox, out.n_touched, out.valid, out.tile_mask)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lfs_project_ut_forward")
    project_ut_forward.launches += 1
    return out


project_ut_forward.launches = 0  # kernel launches since the last reset


# --- the backward ---------------------------------------------------------------------

def project_ut_backward_plain(means, logit_opacities, shN, active_sh_degree, w2c, cam_position,
                              g_depth, g_opacity, g_color):
    """The backward kernel's closed form in plain PyTorch: the gradients of
    project_gaussians_ut's depth, opacity and color (None reads 0) -> those
    of (means, logit_opacities, sh0, shN), each in its input's shape."""
    n = means.shape[0]
    zeros = means.new_zeros
    g_depth = zeros(n) if g_depth is None else g_depth
    g_op = zeros(n) if g_opacity is None else g_opacity
    g_col = zeros((n, 3)) if g_color is None else g_color
    sig = torch.sigmoid(logit_opacities.reshape(-1))
    d_logits = g_op * (1.0 - sig) * sig
    d_means = g_depth[:, None] * w2c[2, :3][None, :]  # depth = (R m + t)_z
    d_means, d_sh0, d_shN = sh_backward_plain(means, shN, active_sh_degree, cam_position, g_col,
                                              d_means)
    return d_means, d_logits.reshape(logit_opacities.shape), d_sh0, d_shN


def project_ut_backward(means, logit_opacities, shN, active_sh_degree, w2c, cam_position,
                        g_depth, g_opacity, g_color):
    """Gradients of (means, logit_opacities, sh0, shN) from those of the
    projection's depth [C], opacity [C] and color [C, 3] (None reads 0): the
    backward kernel for CUDA tensors, project_ut_backward_plain for CPU
    tensors."""
    args = (means, logit_opacities, shN, active_sh_degree, w2c, cam_position, g_depth, g_opacity,
            g_color)
    if not _on_cuda(means):
        return project_ut_backward_plain(*args)
    n = means.shape[0]
    if shN.shape[1] not in SH_RESTS:
        raise ValueError(f"project_ut_backward: shN must hold {SH_RESTS} rows, got {shN.shape[1]}")
    dev = means.device
    g_ptrs, keep = _grad_pointers("project_ut_backward", n, (
        (g_depth, 1), (g_opacity, 1), (g_color, 3)))
    d_means = torch.empty_like(means)
    d_logits = torch.empty(n, dtype=torch.float32, device=dev)
    d_sh0 = torch.empty((n, 1, 3), dtype=torch.float32, device=dev)
    d_shN = torch.empty(shN.shape, dtype=torch.float32, device=dev)
    ins = [t.contiguous() for t in (means, logit_opacities.reshape(-1))]
    err = _build.load_library().lfs_project_ut_backward(
        *(t.data_ptr() for t in ins), _aligned16(shN).data_ptr(),
        _degree_tensor(active_sh_degree, dev).data_ptr(),
        *(t.contiguous().data_ptr() for t in (w2c, cam_position)),
        n, shN.shape[1], *g_ptrs,
        *(t.data_ptr() for t in (d_means, d_logits, d_sh0, d_shN)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lfs_project_ut_backward")
    project_ut_backward.launches += 1
    return d_means, d_logits.reshape(logit_opacities.shape), d_sh0, d_shN


project_ut_backward.launches = 0  # kernel launches since the last reset


# --- the Function ------------------------------------------------------------------------

class _ProjectUT(torch.autograd.Function):
    """project_gaussians_ut as the two kernels: saves only its inputs."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, logit_opacities, sh0, shN, active_mask, degree,
                w2c, cam_position, K, kw):
        out = project_ut_forward(means, log_scales, quats, logit_opacities, sh0, shN,
                                 active_mask, degree, w2c, cam_position, K, **kw)
        ctx.save_for_backward(means, logit_opacities, shN, degree, w2c, cam_position)
        ctx.mark_non_differentiable(out.bbox, out.n_touched, out.valid, out.tile_mask)
        ctx.set_materialize_grads(False)
        return (out.depth, out.mean2d, out.conic, out.opacity, out.color, out.bbox,
                out.n_touched, out.valid, out.tile_mask)

    @staticmethod
    def backward(ctx, g_depth, g_mean2d, g_conic, g_opacity, g_color, *_):
        if g_mean2d is not None or g_conic is not None:
            raise RuntimeError("project_ut: the UT kernels give no gradient through mean2d or "
                               "conic; differentiate them through project_gaussians_ut")
        means, logits, shN, degree, w2c, cam_position = ctx.saved_tensors
        # the backward's own range: its device time reads as the layer's backward
        with stage("ut_projection bwd"):
            d_means, d_logits, d_sh0, d_shN = project_ut_backward(
                means, logits, shN, degree, w2c, cam_position, g_depth, g_opacity, g_color)
        return (d_means, None, None, d_logits, d_sh0, d_shN, None, None, None, None, None, None)


def project_ut(means, log_scales, quats, logit_opacities, sh0, shN, active_mask,
               active_sh_degree, w2c, cam_position, K, *, width: int, height: int,
               tile_size: int = 16, camera_model: int = CameraModelType.PINHOLE,
               radial: torch.Tensor | None = None, tangential: torch.Tensor | None = None,
               near: float = NEAR_PLANE, far: float = FAR_PLANE,
               exact_tile_test: bool = True) -> ProjectedSplats:
    """project_gaussians_ut at a global shutter without antialiasing,
    through the two kernels: the same outputs, differentiable with respect
    to the means, the logit, sh0 and shN through depth, opacity and color
    (mean2d stays in the graph, with no gradient behind it)."""
    kw = dict(width=width, height=height, tile_size=tile_size, camera_model=camera_model,
              radial=radial, tangential=tangential, near=near, far=far,
              exact_tile_test=exact_tile_test)
    degree = _degree_tensor(active_sh_degree, means.device)
    outs = _ProjectUT.apply(means, log_scales, quats, logit_opacities, sh0, shN, active_mask,
                            degree, w2c, cam_position, K, kw)
    return ProjectedSplats(*outs)
