"""EWA projection with SH colour as two hand-written CUDA kernels
(csrc/project_ewa.cu: lfs_project_ewa_forward, lfs_project_ewa_backward),
bound as one autograd Function.

Replaces no TPU kernel: the JAX package leaves the projection
(lichtfeld_studio_tpu/ops/projection.py, ops/sh.py) to XLA, which fuses
it; its plain PyTorch form (ops/projection.py::project_gaussians) is a few
hundred elementwise launches and as many autograd nodes. Both kernels are
bound by device-memory bytes (~300 B a gaussian forward, ~510 B backward):
one thread a gaussian reads its inputs once, shN through shared memory in
coalesced 16-byte pieces, keeps every intermediate in registers, and the
backward recomputes the forward's intermediates from the inputs instead of
saving them (the csrc file's header says more, and how the kept set and
the tile mask come out bit-equal to the plain path's).

Routing (`kernel_route`): CUDA tensors whose camera needs no gradient take
the Function. A camera gradient (pose optimisation: w2c requires grad) keeps
the plain path, since the kernel gives no d w2c; so do CPU tensors. The UT
projection has kernels of its own (kernels/ut_projection.py). On CPU tensors
the Function itself runs the kernels' plain versions: project_gaussians
under no_grad forward, project_ewa_backward_plain backward (the kernel's
closed form in plain PyTorch).
"""

from __future__ import annotations

import torch

from lichtfeld_studio_tpu_torch.kernels import _build
from lichtfeld_studio_tpu_torch.ops.gaussians import quat_to_rotmat
from lichtfeld_studio_tpu_torch.ops.projection import (
    DILATION,
    EXACT_TILE_CAP,
    FAR_PLANE,
    NEAR_PLANE,
    ProjectedSplats,
    project_gaussians,
)
from lichtfeld_studio_tpu_torch.ops.sh import _C1, _C2, _C3, SH_C0, eval_sh_bases
from lichtfeld_studio_tpu_torch.profiling import stage

SH_RESTS = (0, 3, 8, 15)  # shN rows of SH degrees 0-3: the kernels' instances
MAX_EXACT_TILE_CAP = 32  # the tile mask is one int32


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def kernel_route(means: torch.Tensor, w2c: torch.Tensor, cam_position: torch.Tensor,
                 K: torch.Tensor) -> bool:
    """True where the EWA projection takes the kernels: CUDA tensors and a
    camera that needs no gradient."""
    return _on_cuda(means) and not (w2c.requires_grad or cam_position.requires_grad
                                    or K.requires_grad)


def _degree_tensor(active_sh_degree, device) -> torch.Tensor:
    if isinstance(active_sh_degree, torch.Tensor):
        return active_sh_degree.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(active_sh_degree), dtype=torch.int32, device=device)


def _check_inputs(fn, means, log_scales, quats, logits, sh0, shN, w2c, cam_position, K):
    n = means.shape[0]
    expect = {
        "means": (means, (n, 3)), "log_scales": (log_scales, (n, 3)), "quats": (quats, (n, 4)),
        "logit_opacities": (logits, (n,)), "sh0": (sh0, (n, 1, 3)),
        "shN": (shN, (n, shN.shape[1], 3)), "w2c": (w2c, (4, 4)),
        "cam_position": (cam_position, (3,)), "K": (K, (4,)),
    }
    for name, (t, shape) in expect.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != means.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, means on {means.device}")
    if shN.shape[1] not in SH_RESTS:
        raise ValueError(f"{fn}: shN must hold {SH_RESTS} rows (SH degree 0-3), got {shN.shape[1]}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and on a 16-byte boundary (the kernels copy shN in
    16-byte pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# --- the forward --------------------------------------------------------------------

def project_ewa_forward(means, log_scales, quats, logit_opacities, sh0, shN, active_mask,
                        active_sh_degree, w2c, cam_position, K, *, width: int, height: int,
                        tile_size: int = 16, near: float = NEAR_PLANE, far: float = FAR_PLANE,
                        antialiasing: bool = False, exact_tile_cap: int = EXACT_TILE_CAP,
                        dilate_px: float = 0.0) -> ProjectedSplats:
    """project_gaussians' outputs, with no autograd graph: the forward
    kernel for CUDA tensors, the plain path for CPU tensors."""
    logits = logit_opacities.reshape(-1)
    _check_inputs("project_ewa_forward", means, log_scales, quats, logits, sh0, shN, w2c,
                  cam_position, K)
    kw = dict(width=width, height=height, tile_size=tile_size, near=near, far=far,
              antialiasing=antialiasing, exact_tile_cap=exact_tile_cap, dilate_px=dilate_px)
    if not _on_cuda(means):
        with torch.no_grad():
            return project_gaussians(means, log_scales, quats, logits, sh0, shN, active_mask,
                                     active_sh_degree, w2c, cam_position, K, **kw)
    if exact_tile_cap > MAX_EXACT_TILE_CAP:
        raise ValueError(f"project_ewa_forward: exact_tile_cap is at most {MAX_EXACT_TILE_CAP}")
    if active_mask.dtype != torch.bool or tuple(active_mask.shape) != (means.shape[0],):
        raise ValueError(f"project_ewa_forward: active_mask must be bool [C], got "
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
    ins = [t.contiguous() for t in (means, log_scales, quats, logits, sh0)]
    err = _build.load_library().lfs_project_ewa_forward(
        *(t.data_ptr() for t in ins), _aligned16(shN).data_ptr(),
        active_mask.contiguous().data_ptr(), _degree_tensor(active_sh_degree, dev).data_ptr(),
        *(t.contiguous().data_ptr() for t in (w2c, cam_position, K)),
        n, shN.shape[1], width, height, tile_size, exact_tile_cap, int(antialiasing),
        # float32 as torch rounds the plain path's Python floats
        dilate_px, float(tile_size - 1) + 2.0 * dilate_px, near, far,
        *(t.data_ptr() for t in (out.depth, out.mean2d, out.conic, out.opacity, out.color,
                                 out.bbox, out.n_touched, out.valid, out.tile_mask)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lfs_project_ewa_forward")
    project_ewa_forward.launches += 1
    return out


project_ewa_forward.launches = 0  # kernel launches since the last reset


# --- the backward ---------------------------------------------------------------------

def _grad_pointers(fn: str, n: int, grads) -> tuple[list, list]:
    """The backward kernels' gradient inputs, (gradient or None, columns)
    each: the flat (pointer, row stride) pairs the C entries take (None, 0
    for None, which reads 0), rows of unit column stride, and the tensors
    behind the pointers, to keep alive over the launch."""
    ptrs, keep = [], []
    for g, cols in grads:
        if g is None:
            ptrs += [None, 0]
            continue
        if g.dtype != torch.float32 or g.shape[0] != n or g.numel() != n * cols:
            raise ValueError(f"{fn}: a gradient must be float32 [{n}, {cols}], got {g.dtype} "
                             f"{tuple(g.shape)}")
        if g.ndim == 2 and g.stride(1) != 1:
            g = g.contiguous()
        keep.append(g)
        ptrs += [g.data_ptr(), g.stride(0)]
    return ptrs, keep


def _sh_bases_grad(d: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """[C, 3] d loss / d u from the bases' gradients gb [C, 15] at the unit
    directions d [C, 3], x, y, z taken as independent (csrc sh_bases_grad)."""
    x, y, z = d.unbind(-1)
    g = gb.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    c20, c21, c22, c24 = _C2[0], _C2[1], _C2[2], _C2[4]
    c30, c31, c32, c33, c34 = _C3
    gx = (-_C1 * g[2] + c20 * y * g[3] - c20 * z * g[6] + 2 * c24 * x * g[7]
          - 6 * c30 * x * y * g[8] + c31 * y * z * g[9] + c32 * (1 - 5 * zz) * g[12]
          + 2 * c34 * x * z * g[13] + 3 * c30 * (yy - xx) * g[14])
    gy = (-_C1 * g[0] + c20 * x * g[3] + c21 * z * g[4] - 2 * c24 * y * g[7]
          + 3 * c30 * (yy - xx) * g[8] + c31 * x * z * g[9] + c32 * (1 - 5 * zz) * g[10]
          - 2 * c34 * y * z * g[13] + 6 * c30 * x * y * g[14])
    gz = (_C1 * g[1] + c21 * y * g[4] + 2 * c22 * z * g[5] - c20 * x * g[6]
          + c31 * x * y * g[9] - 10 * c32 * y * z * g[10] + c33 * (15 * zz - 3) * g[11]
          - 10 * c32 * x * z * g[12] + c34 * (xx - yy) * g[13])
    return torch.stack([gx, gy, gz], dim=-1)


def _dmax(a, b):
    """d max(a, b) / d a as autograd gives it (half at a tie); _dmin alike."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def _dmin(a, b):
    return torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0))


def project_ewa_backward_plain(means, log_scales, quats, logit_opacities, shN, active_sh_degree,
                               w2c, cam_position, K, g_depth, g_mean2d, g_conic, g_opacity,
                               g_color, *, width: int, height: int, antialiasing: bool = False):
    """The backward kernel's closed form in plain PyTorch: the gradients of
    project_gaussians' depth, mean2d, conic, opacity and color (None reads
    0) -> those of (means, log_scales, quats, logit_opacities, sh0, shN),
    each in its input's shape. It recomputes the forward's intermediates."""
    logits = logit_opacities.reshape(-1)
    n = means.shape[0]
    zeros = means.new_zeros
    g_depth = zeros(n) if g_depth is None else g_depth
    g_mean2d = zeros((n, 2)) if g_mean2d is None else g_mean2d
    g_conic = zeros((n, 3)) if g_conic is None else g_conic
    g_op = zeros(n) if g_opacity is None else g_opacity
    g_col = zeros((n, 3)) if g_color is None else g_color
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    r, t = w2c[:3, :3], w2c[:3, 3]

    # the forward, recomputed (ops/projection.py::project_gaussians)
    p = (means[:, None, :] * r[None]).sum(-1) + t[None, :]
    sdep_ok = p[:, 2].abs() > 1e-12
    sdep = torch.where(sdep_ok, p[:, 2], 1e-12)
    x, y = p[:, 0] / sdep, p[:, 1] / sdep
    clip_l, clip_r = (-0.15 * width - cx) / fx, (1.15 * width - cx) / fx
    clip_t, clip_b = (-0.15 * height - cy) / fy, (1.15 * height - cy) / fy
    mx, my = torch.maximum(x, clip_l), torch.maximum(y, clip_t)
    tx, ty = torch.minimum(mx, clip_r), torch.minimum(my, clip_b)
    j11, j22 = fx / sdep, fy / sdep
    j13, j23 = -j11 * tx, -j22 * ty
    jw1 = j11[:, None] * r[0] + j13[:, None] * r[2]
    jw2 = j22[:, None] * r[1] + j23[:, None] * r[2]
    rot = quat_to_rotmat(quats)
    var = torch.exp(2.0 * log_scales)
    u1 = (jw1[:, :, None] * rot).sum(1)
    u2 = (jw2[:, :, None] * rot).sum(1)
    cxx = (var * u1 * u1).sum(-1) + DILATION
    cxy = (var * u1 * u2).sum(-1)
    cyy = (var * u2 * u2).sum(-1) + DILATION
    det = cxx * cyy - cxy * cxy
    sd_ok = det.abs() > 1e-12
    sd = torch.where(sd_ok, det, 1e-12)
    sig = torch.sigmoid(logits)

    # opacity, and the compensation's share of cov2d
    g_cxx, g_cxy, g_cyy, g_sd, g_sig = zeros(n), zeros(n), zeros(n), zeros(n), g_op
    if antialiasing:
        dx0, dy0 = cxx - DILATION, cyy - DILATION
        det_raw = dx0 * dy0 - cxy * cxy
        ratio = torch.clamp(det_raw, min=0.0) / sd
        pos = ratio > 0
        root = torch.where(pos, torch.sqrt(torch.where(pos, ratio, 1.0)), 0.0)
        g_sig = g_op * root
        g_r = torch.where(pos, g_op * sig / (2.0 * torch.where(pos, root, 1.0)), 0.0)
        g_sd = g_sd - g_r * ratio / sd
        g_dr = torch.where(det_raw >= 0, g_r / sd, 0.0)
        g_cxx, g_cyy, g_cxy = g_cxx + g_dr * dy0, g_cyy + g_dr * dx0, g_cxy - 2 * cxy * g_dr
    g_logit = g_sig * (1.0 - sig) * sig

    # conic = (c_yy, -c_xy, c_xx) / safe_det
    ga, gb, gc = g_conic.unbind(-1)
    g_cyy = g_cyy + ga / sd
    g_cxy = g_cxy - gb / sd
    g_cxx = g_cxx + gc / sd
    g_sd = g_sd - (ga * cyy / sd - gb * cxy / sd + gc * cxx / sd) / sd
    g_det = torch.where(sd_ok, g_sd, 0.0)
    g_cxx, g_cyy, g_cxy = g_cxx + g_det * cyy, g_cyy + g_det * cxx, g_cxy - 2 * cxy * g_det

    # cov2d: the log-scales and (J W R)
    g_var = g_cxx[:, None] * u1 * u1 + g_cxy[:, None] * u1 * u2 + g_cyy[:, None] * u2 * u2
    d_ls = 2.0 * var * g_var
    g_u1 = var * (2.0 * g_cxx[:, None] * u1 + g_cxy[:, None] * u2)
    g_u2 = var * (2.0 * g_cyy[:, None] * u2 + g_cxy[:, None] * u1)
    g_jw1 = (g_u1[:, None, :] * rot).sum(-1)
    g_jw2 = (g_u2[:, None, :] * rot).sum(-1)
    g_rot = jw1[:, :, None] * g_u1[:, None, :] + jw2[:, :, None] * g_u2[:, None, :]
    g_j11 = (g_jw1 * r[0]).sum(-1)
    g_j13 = (g_jw1 * r[2]).sum(-1)
    g_j22 = (g_jw2 * r[1]).sum(-1)
    g_j23 = (g_jw2 * r[2]).sum(-1)
    g_j11 = g_j11 - g_j13 * tx
    g_j22 = g_j22 - g_j23 * ty
    g_x = -g_j13 * j11 * _dmin(mx, clip_r) * _dmax(x, clip_l) + g_mean2d[:, 0] * fx
    g_y = -g_j23 * j22 * _dmin(my, clip_b) * _dmax(y, clip_t) + g_mean2d[:, 1] * fy
    g_sdep = -(g_j11 * j11 + g_j22 * j22 + g_x * x + g_y * y) / sdep
    g_p = torch.stack([g_x / sdep, g_y / sdep, g_depth + torch.where(sdep_ok, g_sdep, 0.0)], -1)
    d_means = (g_p[:, :, None] * r[None]).sum(1)

    # the rotation from the quaternion
    w, qx, qy, qz = quats.unbind(-1)
    nsum = w * w + qx * qx + qy * qy + qz * qz
    nc = torch.clamp(nsum, min=1e-24)
    s = 2.0 / nc
    gr = g_rot
    gxx, gyy = -(gr[:, 1, 1] + gr[:, 2, 2]), -(gr[:, 0, 0] + gr[:, 2, 2])
    gzz = -(gr[:, 0, 0] + gr[:, 1, 1])
    gxy, gwz = gr[:, 0, 1] + gr[:, 1, 0], gr[:, 1, 0] - gr[:, 0, 1]
    gwy, gxz = gr[:, 0, 2] - gr[:, 2, 0], gr[:, 0, 2] + gr[:, 2, 0]
    gyz, gwx = gr[:, 1, 2] + gr[:, 2, 1], gr[:, 2, 1] - gr[:, 1, 2]
    g_s = (gxx * qx * qx + gyy * qy * qy + gzz * qz * qz + gxy * qx * qy + gxz * qx * qz
           + gyz * qy * qz + gwx * w * qx + gwy * w * qy + gwz * w * qz)
    g_n = torch.where(nsum >= 1e-24, -g_s * s / nc, 0.0)
    d_quats = torch.stack([
        s * (gwx * qx + gwy * qy + gwz * qz) + 2 * w * g_n,
        s * (2 * gxx * qx + gxy * qy + gxz * qz + gwx * w) + 2 * qx * g_n,
        s * (2 * gyy * qy + gxy * qx + gyz * qz + gwy * w) + 2 * qy * g_n,
        s * (2 * gzz * qz + gxz * qx + gyz * qy + gwz * w) + 2 * qz * g_n,
    ], dim=-1)

    d_means, d_sh0, d_shN = sh_backward_plain(means, shN, active_sh_degree, cam_position, g_col,
                                              d_means)
    return (d_means, d_ls, d_quats, g_logit.reshape(logit_opacities.shape), d_sh0, d_shN)


def sh_backward_plain(means, shN, active_sh_degree, cam_position, g_col, d_means):
    """The SH colour's backward (csrc/project_common.cuh sh_color_backward)
    in plain PyTorch: from the colour's gradient g_col [C, 3], (d_means with
    the view direction's share added, d sh0, d shN)."""
    d_sh0 = (SH_C0 * g_col)[:, None, :]
    n_rest = shN.shape[1]
    d_shN = torch.zeros_like(shN)
    if n_rest > 0:
        direction = means - cam_position[None, :]
        norm = torch.linalg.norm(direction, dim=-1)
        ncl = torch.clamp(norm, min=1e-12)
        u = direction / ncl[:, None]
        bases = eval_sh_bases(u)[:, :15]
        degree = torch.as_tensor(active_sh_degree, device=means.device)
        on = torch.arange(1, 16, device=means.device) < (degree + 1) ** 2  # [15]
        on = on & (torch.arange(15, device=means.device) < n_rest)
        d_shN = torch.where(on[:n_rest, None], bases[:, :n_rest, None], 0.0) * g_col[:, None, :]
        g_b = torch.zeros_like(bases)
        g_b[:, :n_rest] = (g_col[:, None, :] * shN).sum(-1)
        g_b = torch.where(on[None, :], g_b, 0.0)
        g_u = _sh_bases_grad(u, g_b)
        radial = torch.where((norm >= 1e-12) & (norm > 0), (g_u * u).sum(-1) / norm, 0.0)
        d_means = d_means + g_u / ncl[:, None] - (radial / ncl)[:, None] * direction
    return d_means, d_sh0, d_shN


def project_ewa_backward(means, log_scales, quats, logit_opacities, shN, active_sh_degree, w2c,
                         cam_position, K, g_depth, g_mean2d, g_conic, g_opacity, g_color, *,
                         width: int, height: int, antialiasing: bool = False):
    """Gradients of (means, log_scales, quats, logit_opacities, sh0, shN)
    from those of the projection's depth [C], mean2d [C, 2], conic [C, 3],
    opacity [C] and color [C, 3] (None reads 0): the backward kernel for
    CUDA tensors, project_ewa_backward_plain for CPU tensors."""
    kw = dict(width=width, height=height, antialiasing=antialiasing)
    args = (means, log_scales, quats, logit_opacities, shN, active_sh_degree, w2c, cam_position,
            K, g_depth, g_mean2d, g_conic, g_opacity, g_color)
    if not _on_cuda(means):
        return project_ewa_backward_plain(*args, **kw)
    logits = logit_opacities.reshape(-1)
    n = means.shape[0]
    if shN.shape[1] not in SH_RESTS:
        raise ValueError(f"project_ewa_backward: shN must hold {SH_RESTS} rows, got {shN.shape[1]}")
    dev = means.device
    g_ptrs, keep = _grad_pointers("project_ewa_backward", n, (
        (g_depth, 1), (g_mean2d, 2), (g_conic, 3), (g_opacity, 1), (g_color, 3)))
    d_means, d_ls = torch.empty_like(means), torch.empty_like(log_scales)
    d_quats = torch.empty((n, 4), dtype=torch.float32, device=dev)
    d_logits = torch.empty(n, dtype=torch.float32, device=dev)
    d_sh0 = torch.empty((n, 1, 3), dtype=torch.float32, device=dev)
    d_shN = torch.empty(shN.shape, dtype=torch.float32, device=dev)
    ins = [t.contiguous() for t in (means, log_scales, quats, logits)]
    err = _build.load_library().lfs_project_ewa_backward(
        *(t.data_ptr() for t in ins), _aligned16(shN).data_ptr(),
        _degree_tensor(active_sh_degree, dev).data_ptr(),
        *(t.contiguous().data_ptr() for t in (w2c, cam_position, K)),
        n, shN.shape[1], width, height, int(antialiasing), *g_ptrs,
        *(t.data_ptr() for t in (d_means, d_ls, d_quats, d_logits, d_sh0, d_shN)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lfs_project_ewa_backward")
    project_ewa_backward.launches += 1
    return d_means, d_ls, d_quats, d_logits.reshape(logit_opacities.shape), d_sh0, d_shN


project_ewa_backward.launches = 0  # kernel launches since the last reset


# --- the Function ------------------------------------------------------------------------

class _ProjectEWA(torch.autograd.Function):
    """project_gaussians as the two kernels: saves only its inputs."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, logit_opacities, sh0, shN, active_mask, degree,
                w2c, cam_position, K, kw):
        out = project_ewa_forward(means, log_scales, quats, logit_opacities, sh0, shN,
                                  active_mask, degree, w2c, cam_position, K, **kw)
        ctx.save_for_backward(means, log_scales, quats, logit_opacities, shN, degree, w2c,
                              cam_position, K)
        ctx.kw = dict(width=kw["width"], height=kw["height"], antialiasing=kw["antialiasing"])
        ctx.mark_non_differentiable(out.bbox, out.n_touched, out.valid, out.tile_mask)
        ctx.set_materialize_grads(False)
        return (out.depth, out.mean2d, out.conic, out.opacity, out.color, out.bbox,
                out.n_touched, out.valid, out.tile_mask)

    @staticmethod
    def backward(ctx, g_depth, g_mean2d, g_conic, g_opacity, g_color, *_):
        (means, log_scales, quats, logits, shN, degree, w2c, cam_position,
         K) = ctx.saved_tensors
        with stage("projection"):
            grads = project_ewa_backward(means, log_scales, quats, logits, shN, degree, w2c,
                                         cam_position, K, g_depth, g_mean2d, g_conic, g_opacity,
                                         g_color, **ctx.kw)
        return (*grads, None, None, None, None, None, None)


def project_ewa(means, log_scales, quats, logit_opacities, sh0, shN, active_mask,
                active_sh_degree, w2c, cam_position, K, *, width: int, height: int,
                tile_size: int = 16, near: float = NEAR_PLANE, far: float = FAR_PLANE,
                antialiasing: bool = False, exact_tile_cap: int = EXACT_TILE_CAP,
                dilate_px: float = 0.0) -> ProjectedSplats:
    """project_gaussians through the two kernels, differentiable with
    respect to the gaussians' parameters (not the camera). Same arguments
    and outputs."""
    kw = dict(width=width, height=height, tile_size=tile_size, near=near, far=far,
              antialiasing=antialiasing, exact_tile_cap=exact_tile_cap, dilate_px=dilate_px)
    degree = _degree_tensor(active_sh_degree, means.device)
    outs = _ProjectEWA.apply(means, log_scales, quats, logit_opacities, sh0, shN, active_mask,
                             degree, w2c, cam_position, K, kw)
    return ProjectedSplats(*outs)
