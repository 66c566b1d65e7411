"""3DGUT unscented-transform projection for every camera model (counterpart
of lichtfeld_studio_tpu/ops/ut_projection.py; reference
gsplat/ProjectionUT3DGSFused.cu:16-289 and Cameras.cuh).

Seven sigma points per gaussian (Wan & van der Merwe defaults alpha=0.1,
beta=2, kappa=0) go through the camera model: PINHOLE, OPENCV_PINHOLE
(rational radial + tangential distortion), OPENCV_FISHEYE (equidistant
with a theta polynomial) or ORTHO. Their weighted mean and covariance give
the image mean and the 2D covariance (+eps2d), then the conic, bounds and
tile mask the EWA path shares (ops/projection.py::screen_bounds).

Rolling shutters: each sigma point is projected through a pose slerped at
its own scanline time, a fixed point unrolled N_ROLLING_SHUTTER_ITERATIONS
= 10 times (Cameras.cuh:347-413); the depth cull uses the mid-frame pose.
Everything is float32 and differentiable with respect to the gaussians
(not the camera); no matmul, so TF32 never enters.
"""

from __future__ import annotations

import torch

from lichtfeld_studio_tpu_torch.core.camera import CameraModelType, ShutterType
from lichtfeld_studio_tpu_torch.ops.gaussians import quat_to_rotmat
from lichtfeld_studio_tpu_torch.ops.projection import (
    FAR_PLANE,
    MIN_ALPHA_THRESHOLD,
    NEAR_PLANE,
    ProjectedSplats,
    _safe_sqrt,
    screen_bounds,
)
from lichtfeld_studio_tpu_torch.ops.sh import sh_to_color

UT_ALPHA = 0.1
UT_BETA = 2.0
UT_KAPPA = 0.0
UT_MARGIN = 0.1
EPS2D = 0.3
N_ROLLING_SHUTTER_ITERATIONS = 10  # Cameras.cuh:346


def _rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[3, 3] rotation -> [4] wxyz quaternion (branch-free Shepperd)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) / 2.0
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) / 2.0
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) / 2.0
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) / 2.0
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    q = torch.stack([qw, qx, qy, qz])
    return q / torch.clamp(torch.linalg.norm(q), min=1e-12)


def _quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Slerp q0 [4] -> q1 [4] at t [...]; returns [..., 4] (glm::slerp)."""
    dot = (q0 * q1).sum()
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = dot.abs()
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-4
    safe_sin = torch.where(use_lerp, 1.0, sin_theta)
    t = t[..., None]
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe_sin)
    q = w0 * q0 + w1 * q1
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def _quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v [..., 3] by q [..., 4] (wxyz)."""
    u = q[..., 1:4].expand(v.shape)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (q[..., 0:1] * uv + uuv)


def _shutter_time(img_pts: torch.Tensor, shutter_type: int, width: int, height: int) -> torch.Tensor:
    """Relative frame time of image points [..., 2]
    (Cameras.cuh:294-318 shutter_relative_frame_time)."""
    x, y = img_pts[..., 0], img_pts[..., 1]
    if shutter_type == ShutterType.ROLLING_TOP_TO_BOTTOM:
        t = torch.floor(y) / (height - 1)
    elif shutter_type == ShutterType.ROLLING_LEFT_TO_RIGHT:
        t = torch.floor(x) / (width - 1)
    elif shutter_type == ShutterType.ROLLING_BOTTOM_TO_TOP:
        t = (height - torch.ceil(y)) / (height - 1)
    elif shutter_type == ShutterType.ROLLING_RIGHT_TO_LEFT:
        t = (width - torch.ceil(x)) / (width - 1)
    else:
        t = torch.zeros_like(x)
    return torch.clamp(t, 0.0, 1.0)


def ut_weights(device):
    """The unscented transform's constants: sqrt(D + lambda) (a Python
    float, the sigma points' offset in standard deviations) and the float32
    weights of the seven points' mean and covariance, w_mean [7], w_cov [7]."""
    d = 3.0
    lam = UT_ALPHA**2 * (d + UT_KAPPA) - d
    w0 = lam / (d + lam)
    wi = 1.0 / (2.0 * (d + lam))
    w_mean = torch.tensor([w0] + [wi] * 6, dtype=torch.float32, device=device)
    w_cov = w_mean.clone()
    w_cov[0] += 1.0 - UT_ALPHA**2 + UT_BETA
    return (d + lam) ** 0.5, w_mean, w_cov


def _sigma_points(means, log_scales, quats):
    """[C,3],[C,3],[C,4] -> points [C,7,3], w_mean [7], w_cov [7]."""
    delta, w_mean, w_cov = ut_weights(means.device)
    rot = quat_to_rotmat(quats)  # [C, 3, 3]; columns are the gaussian axes
    scale = torch.exp(log_scales)
    # delta_i = sqrt(D+lambda) * s_i * R[:, i]
    deltas = (delta * scale[:, None, :] * rot).transpose(1, 2)  # [C, i, xyz]
    m = means[:, None, :]
    pts = torch.cat([m, m + deltas, m - deltas], dim=1)  # [C, 7, 3]
    return pts, w_mean, w_cov


def _coeffs(c: torch.Tensor | None, n: int, device) -> torch.Tensor:
    """Distortion coefficients zero-padded (or cut) to n entries."""
    out = torch.zeros(n, dtype=torch.float32, device=device)
    if c is not None and c.numel():
        m = min(c.numel(), n)
        out[:m] = c.reshape(-1)[:m].to(device)
    return out


def _distort_opencv(x, y, radial, tangential):
    """OpenCV rational radial + tangential distortion of normalized coords
    (Cameras.cuh:640-660)."""
    k = _coeffs(radial, 6, x.device)
    p = _coeffs(tangential, 2, x.device)
    r2 = x * x + y * y
    alpha = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
    beta = 1.0 + r2 * (k[3] + r2 * (k[4] + r2 * k[5]))
    d = alpha / beta
    xd = x * d + 2.0 * p[0] * x * y + p[1] * (r2 + 2.0 * x * x)
    yd = y * d + p[0] * (r2 + 2.0 * y * y) + 2.0 * p[1] * x * y
    return xd, yd


def _distort_fisheye(x, y, z, radial):
    """Equidistant fisheye with the theta polynomial -> normalized
    image-plane coords."""
    k = _coeffs(radial, 4, x.device)
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8), 1.0)
    return x * scale, y * scale


def _project_points(p_cam, K, camera_model, radial, tangential, width, height):
    """Camera-space points [..., 3] -> (image points [..., 2], valid [...])."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    z = p_cam[..., 2]
    safe_z = torch.where(z.abs() > 1e-8, z, 1e-8)
    if camera_model == CameraModelType.ORTHO:
        u = p_cam[..., 0] * fx + cx
        v = p_cam[..., 1] * fy + cy
        valid_z = z > 0
    elif camera_model == CameraModelType.OPENCV_FISHEYE:
        xd, yd = _distort_fisheye(p_cam[..., 0], p_cam[..., 1], z, radial)
        u = xd * fx + cx
        v = yd * fy + cy
        valid_z = z > 1e-8  # fisheye can exceed 180 degrees; conservative
    else:
        x = p_cam[..., 0] / safe_z
        y = p_cam[..., 1] / safe_z
        if camera_model == CameraModelType.OPENCV_PINHOLE:
            x, y = _distort_opencv(x, y, radial, tangential)
        u = x * fx + cx
        v = y * fy + cy
        valid_z = z > 0
    m = UT_MARGIN
    in_img = (u >= -m * width) & (u <= (1 + m) * width) & (v >= -m * height) & (v <= (1 + m) * height)
    return torch.stack([u, v], dim=-1), valid_z & in_img


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis, first to last."""
    out = x[0]
    for k in range(1, x.shape[0]):
        out = out + x[k]
    return out


def project_gaussians_ut(
    means: torch.Tensor,  # [C, 3]
    log_scales: torch.Tensor,  # [C, 3]
    quats: torch.Tensor,  # [C, 4]
    logit_opacities: torch.Tensor,  # [C] or [C, 1]
    sh0: torch.Tensor,  # [C, 1, 3]
    shN: torch.Tensor,  # [C, K-1, 3]
    active_mask: torch.Tensor,  # [C] bool
    active_sh_degree: torch.Tensor | int,
    w2c: torch.Tensor,  # [4, 4]
    cam_position: torch.Tensor,  # [3]
    K: torch.Tensor,  # [4]
    *,
    width: int,
    height: int,
    tile_size: int = 16,
    camera_model: int = CameraModelType.PINHOLE,
    radial: torch.Tensor | None = None,
    tangential: torch.Tensor | None = None,
    near: float = NEAR_PLANE,
    far: float = FAR_PLANE,
    eps2d: float = EPS2D,
    antialiasing: bool = False,
    w2c_end: torch.Tensor | None = None,
    shutter_type: int = ShutterType.GLOBAL,
    exact_tile_test: bool = True,
) -> ProjectedSplats:
    """UT projection. exact_tile_test=False keeps the conservative full
    bbox, which the per-pixel world-space blend needs: its footprint is not
    bounded by the UT conic that the exact test evaluates."""
    if logit_opacities.ndim == 2:
        logit_opacities = logit_opacities[:, 0]
    rolling = shutter_type != ShutterType.GLOBAL and w2c_end is not None

    rot_w2c = w2c[:3, :3]
    t_w2c = w2c[:3, 3]
    if rolling:
        # mid-frame pose for the centre depth cull
        # (ProjectionUT3DGSFused.cu:76-78 interpolate_shutter_pose(0.5))
        q0 = _rotmat_to_quat(rot_w2c)
        q1 = _rotmat_to_quat(w2c_end[:3, :3])
        t1 = w2c_end[:3, 3]
        q_mid = _quat_slerp(q0, q1, torch.tensor(0.5, device=means.device))
        t_mid = 0.5 * (t_w2c + t1)
        mean_c = _quat_rotate(q_mid[None, :], means) + t_mid[None, :]
    else:
        mean_c = (
            means[:, 0:1] * rot_w2c[:, 0][None, :]
            + means[:, 1:2] * rot_w2c[:, 1][None, :]
            + means[:, 2:3] * rot_w2c[:, 2][None, :]
            + t_w2c[None, :]
        )
    depth = mean_c[:, 2]
    valid = active_mask & (depth >= near) & (depth <= far)

    opacity = torch.sigmoid(logit_opacities)
    valid &= opacity >= MIN_ALPHA_THRESHOLD
    valid &= (quats * quats).sum(-1) >= 1e-8

    pts, w_mean, w_cov = _sigma_points(means, log_scales, quats)  # [C, 7, 3]

    if rolling:
        def proj_with(q, t):
            return _project_points(_quat_rotate(q, pts) + t, K, camera_model, radial, tangential,
                                   width, height)

        # per-sigma-point shutter-pose fixed point: start from the
        # start-of-frame projection (else the end's), then iterate
        # time -> slerped pose -> reprojection
        img0, valid0 = proj_with(q0[None, None, :], t_w2c[None, None, :])
        img1, valid1 = proj_with(q1[None, None, :], t1[None, None, :])
        img_pts = torch.where(valid0[..., None], img0, img1)
        init_valid = valid0 | valid1
        pt_valid = init_valid
        for _ in range(N_ROLLING_SHUTTER_ITERATIONS):
            rft = _shutter_time(img_pts, shutter_type, width, height)  # [C, 7]
            q_rs = _quat_slerp(q0, q1, rft)  # [C, 7, 4]
            t_rs = (1.0 - rft)[..., None] * t_w2c + rft[..., None] * t1
            img_rs, valid_rs = proj_with(q_rs, t_rs)
            img_pts = torch.where(init_valid[..., None], img_rs, img_pts)
            pt_valid = init_valid & valid_rs
    else:
        p_cam = (
            pts[..., 0:1] * rot_w2c[:, 0]
            + pts[..., 1:2] * rot_w2c[:, 1]
            + pts[..., 2:3] * rot_w2c[:, 2]
            + t_w2c
        )
        img_pts, pt_valid = _project_points(p_cam, K, camera_model, radial, tangential,
                                            width, height)  # [C, 7, 2], [C, 7]
    valid &= pt_valid.all(dim=1)  # require_all_sigma_points_valid

    # weighted sums over the 7 points in order: w_mean[0] = -99 cancels
    # against the other six, so the order of the float32 sum shows
    mean2d = _ordered_sum(w_mean[:, None, None] * img_pts.transpose(0, 1))  # [C, 2]
    dev = img_pts - mean2d[:, None, :]  # [C, 7, 2]
    cov = _ordered_sum(w_cov[:, None, None, None] * (dev[..., :, None] * dev[..., None, :]).transpose(0, 1))
    c_xx = cov[:, 0, 0] + eps2d
    c_xy = cov[:, 0, 1]
    c_yy = cov[:, 1, 1] + eps2d

    det = c_xx * c_yy - c_xy * c_xy
    valid &= det >= 1e-8
    safe_det = torch.where(det.abs() > 1e-12, det, 1e-12)
    conic = torch.stack([c_yy / safe_det, -c_xy / safe_det, c_xx / safe_det], dim=-1)

    if antialiasing:
        # compensation against the un-dilated covariance
        # (ProjectionUT3DGSFused.cu compensations output; rasterizer.cpp:181)
        det_raw = (c_xx - eps2d) * (c_yy - eps2d) - c_xy * c_xy
        opacity = opacity * _safe_sqrt(torch.clamp(det_raw, min=0.0) / safe_det)
        valid &= opacity >= MIN_ALPHA_THRESHOLD

    bbox, n_touched, valid, tile_mask = screen_bounds(
        mean2d, conic, c_xx, c_yy, opacity, valid, width=width, height=height,
        tile_size=tile_size, exact_tile_test=exact_tile_test)
    color = sh_to_color(sh0, shN, means, cam_position, active_sh_degree)
    return ProjectedSplats(
        depth=depth, mean2d=mean2d, conic=conic, opacity=opacity, color=color, bbox=bbox,
        n_touched=n_touched, valid=valid, tile_mask=tile_mask,
    )
