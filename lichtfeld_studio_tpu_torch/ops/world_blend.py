"""Exact per-pixel world-space (3DGUT) rasterization: ray tables and the
dense oracle (counterpart of lichtfeld_studio_tpu/ops/world_blend.py;
reference gsplat/RasterizeToPixelsFromWorld3DGSFwd.cu:20-442).

Every pixel casts a world ray through the (possibly distorted, possibly
rolling-shutter) camera, and each 3D gaussian is evaluated at the ray's
closest approach in the gaussian's normalised frame:

    M    = diag(1/s) R^T
    gro  = M (ray_o - mean),  grd = M ray_d
    dist = |grd x gro|^2 / |grd|^2      (squared min Mahalanobis distance)
    alpha = min(0.999, opacity exp(-dist / 2)), kept when >= 1/255

The camera-model inverse is evaluated once per pixel into a ray table
(PINHOLE, OpenCV-pinhole Newton undistortion, fisheye theta Newton,
ORTHO; rolling shutters use each scanline's slerped pose). An ORTHO pixel
has its own origin, camera-space ((px - cx) / fx, (py - cy) / fy, 0), the
inverse of ops/ut_projection.py's ortho mapping, and the direction
R^T (0, 0, 1). The tables are plain autograd: with a pose gradient they
carry d loss / d w2c (rasterize builds them without autograd on the
P5/P6 route, whose backward returns no ray gradient).

`world_blend_tiles` is the dense per-tile blend over the binned instances:
the port's oracle for the streaming kernels P5/P6 (kernels/world_blend.py).
It carries exact per-pixel ray origins, autograd differentiates it, and it
runs in groups of tiles with no k_max cut. Under autograd each group is a
recomputed region (torch.utils.checkpoint): the graph keeps only the
group's inputs and outputs, and the backward rebuilds its [t, K, P, ...]
intermediates one group at a time, so a full-width frame with a pose
gradient holds one group's intermediates, not every group's.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from lichtfeld_studio_tpu_torch.core.camera import CameraModelType, ShutterType
from lichtfeld_studio_tpu_torch.kernels.blend import _gather_group, _plain_groups, _untile
from lichtfeld_studio_tpu_torch.ops.blend_ref import blend_along_axis
from lichtfeld_studio_tpu_torch.ops.gaussians import quat_to_rotmat
from lichtfeld_studio_tpu_torch.ops.projection import MAX_FRAGMENT_ALPHA, MIN_ALPHA_THRESHOLD
from lichtfeld_studio_tpu_torch.ops.ut_projection import (
    _coeffs,
    _quat_rotate,
    _quat_slerp,
    _rotmat_to_quat,
    _shutter_time,
)


def _undistort_opencv_newton(xd, yd, radial, tangential, iters: int = 5):
    """Invert the OpenCV rational radial + tangential distortion by Newton
    iteration on normalised coords (Cameras.cuh:700-747), with the 2x2
    Jacobian written out."""
    k = _coeffs(radial, 6, xd.device)
    p = _coeffs(tangential, 2, xd.device)
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        num = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
        den = 1.0 + r2 * (k[3] + r2 * (k[4] + r2 * k[5]))
        icd = num / den
        # d(icd)/d(r2), with d(r2)/dx = 2x and d(r2)/dy = 2y
        d_num = k[0] + r2 * (2.0 * k[1] + 3.0 * r2 * k[2])
        d_den = k[3] + r2 * (2.0 * k[4] + 3.0 * r2 * k[5])
        d_icd = (d_num * den - num * d_den) / (den * den)
        fx = icd * x + 2.0 * p[0] * x * y + p[1] * (r2 + 2.0 * x * x) - xd
        fy = icd * y + 2.0 * p[1] * x * y + p[0] * (r2 + 2.0 * y * y) - yd
        gx1 = icd + 2.0 * x * x * d_icd + 2.0 * p[0] * y + 6.0 * p[1] * x  # dfx/dx
        gx2 = 2.0 * x * y * d_icd + 2.0 * p[0] * x + 2.0 * p[1] * y  # dfx/dy
        gy1 = 2.0 * x * y * d_icd + 2.0 * p[1] * y + 2.0 * p[0] * x  # dfy/dx
        gy2 = icd + 2.0 * y * y * d_icd + 2.0 * p[1] * x + 6.0 * p[0] * y  # dfy/dy
        det = gx1 * gy2 - gx2 * gy1
        det = torch.where(det.abs() > 1e-12, det, 1e-12)
        x, y = x - (fx * gy2 - fy * gx2) / det, y - (fy * gx1 - fx * gy1) / det
    return x, y


def _fisheye_theta_newton(delta, radial, iters: int = 10):
    """Solve delta = theta (1 + k1 t^2 + k2 t^4 + k3 t^6 + k4 t^8) for theta
    (the equidistant fisheye polynomial, Cameras.cuh:961-983)."""
    k = _coeffs(radial, 4, delta.device)
    theta = delta
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))) - delta
        df = 1.0 + t2 * (3.0 * k[0] + t2 * (5.0 * k[1] + t2 * (7.0 * k[2] + t2 * 9.0 * k[3])))
        theta = theta - f / torch.where(df.abs() > 1e-9, df, 1e-9)
    return theta


def _pixel_centres(width: int, height: int, tile_size: int, device):
    """(px, py) [Hp, Wp] pixel centres of the tile-padded grid."""
    hp = -(-height // tile_size) * tile_size
    wp = -(-width // tile_size) * tile_size
    ys, xs = torch.meshgrid(torch.arange(hp, device=device), torch.arange(wp, device=device),
                            indexing="ij")
    return xs.to(torch.float32) + 0.5, ys.to(torch.float32) + 0.5


def camera_ray_table(
    K: torch.Tensor,  # [4] fx fy cx cy
    camera_model: int,
    radial: torch.Tensor | None,
    tangential: torch.Tensor | None,
    width: int,
    height: int,
    tile_size: int = 16,
) -> torch.Tensor:
    """Per-pixel camera-space ray directions on the tile-padded grid
    -> [Hp, Wp, 3] (row-major pixels); ORTHO's is (0, 0, 1) everywhere,
    its per-pixel origins are `ortho_ray_origins`'s."""
    px, py = _pixel_centres(width, height, tile_size, K.device)
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    u = (px - cx) / fx
    v = (py - cy) / fy
    if camera_model == CameraModelType.ORTHO:
        return torch.stack([torch.zeros_like(u), torch.zeros_like(v), torch.ones_like(u)], -1)
    if camera_model == CameraModelType.OPENCV_FISHEYE:
        delta = torch.sqrt(u * u + v * v)
        theta = _fisheye_theta_newton(delta, radial)
        scale = torch.where(delta > 1e-8, torch.sin(theta) / torch.clamp(delta, min=1e-8), 1.0)
        return torch.stack([scale * u, scale * v, torch.cos(theta)], -1)
    distorted = any(c is not None and c.numel() for c in (radial, tangential))
    if camera_model == CameraModelType.OPENCV_PINHOLE and distorted:
        u, v = _undistort_opencv_newton(u, v, radial, tangential)
    dirs = torch.stack([u, v, torch.ones_like(u)], -1)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def ortho_ray_origins(K: torch.Tensor, width: int, height: int, tile_size: int = 16
                      ) -> torch.Tensor:
    """Camera-space ray origins of an ORTHO camera on the tile-padded grid,
    ((px - cx) / fx, (py - cy) / fy, 0) -> [Hp * Wp, 3]."""
    px, py = _pixel_centres(width, height, tile_size, K.device)
    u = (px - K[2]) / K[0]
    v = (py - K[3]) / K[1]
    return torch.stack([u, v, torch.zeros_like(u)], -1).reshape(-1, 3)


def pixel_shutter_times(shutter_type: int, width: int, height: int, tile_size: int,
                        device) -> torch.Tensor:
    """Relative frame time tau of every pixel of the tile-padded grid,
    [Hp * Wp] row-major (its scanline's time, Cameras.cuh:294-318)."""
    px, py = _pixel_centres(width, height, tile_size, device)
    return _shutter_time(torch.stack([px, py], -1).reshape(-1, 2), shutter_type, width, height)


def world_ray_table(
    w2c: torch.Tensor,
    K: torch.Tensor,
    camera_model: int,
    radial: torch.Tensor | None,
    tangential: torch.Tensor | None,
    width: int,
    height: int,
    tile_size: int = 16,
    w2c_end: torch.Tensor | None = None,
    shutter_type: int = ShutterType.GLOBAL,
) -> tuple[torch.Tensor, torch.Tensor]:
    """World-space (ray_o, ray_d), each [Hp*Wp, 3] in row-major pixel order.
    Rolling shutter: each pixel takes its scanline's slerped pose
    (Cameras.cuh:322-341 image_point_to_world_ray_shutter_pose). ORTHO:
    each pixel's camera-space origin goes to the world by the inverse of
    its pose."""
    d = camera_ray_table(K, camera_model, radial, tangential, width, height, tile_size)
    d = d.reshape(-1, 3)
    ortho = camera_model == CameraModelType.ORTHO
    o_cam = ortho_ray_origins(K, width, height, tile_size) if ortho else None
    if shutter_type == ShutterType.GLOBAL or w2c_end is None:
        r_inv = w2c[:3, :3].T
        ray_d = (d[:, :, None] * r_inv.T[None, :, :]).sum(1)  # d @ r_inv.T
        if ortho:  # R^T (o_cam - t)
            return ((o_cam - w2c[:3, 3])[:, :, None] * r_inv.T[None, :, :]).sum(1), ray_d
        o = -(r_inv * w2c[:3, 3][None, :]).sum(-1)
        return o[None, :].expand(ray_d.shape), ray_d
    q0 = _rotmat_to_quat(w2c[:3, :3])
    q1 = _rotmat_to_quat(w2c_end[:3, :3])
    t0, t1 = w2c[:3, 3], w2c_end[:3, 3]
    t = pixel_shutter_times(shutter_type, width, height, tile_size, w2c.device)
    q_rs = _quat_slerp(q0, q1, t)  # [P, 4]
    t_rs = (1.0 - t)[:, None] * t0 + t[:, None] * t1
    q_inv = q_rs * torch.tensor([1.0, -1.0, -1.0, -1.0], device=w2c.device)
    return _quat_rotate(q_inv, o_cam - t_rs if ortho else -t_rs), _quat_rotate(q_inv, d)


def pack_world_features(
    means: torch.Tensor,  # [C, 3]
    log_scales: torch.Tensor,  # [C, 3]
    quats: torch.Tensor,  # [C, 4]
    opacity: torch.Tensor,  # [C] activated
    color: torch.Tensor,  # [C, 3]
    depth: torch.Tensor | None = None,
) -> torch.Tensor:
    """[C, 16]: 0-2 mean, 3-6 normalised quat, 7-9 1/scale, 10 opacity,
    11-13 rgb, 14 depth (or 0), 15 pad."""
    qn = quats / torch.clamp(torch.linalg.norm(quats, dim=-1, keepdim=True), min=1e-12)
    zeros = torch.zeros_like(opacity)
    aux = depth if depth is not None else zeros
    return torch.cat([means, qn, torch.exp(-log_scales), opacity[:, None], color[:, :3],
                      aux[:, None], zeros[:, None]], dim=-1)


def _alphas_world(f, ray_o, ray_d):
    """f [T, K, 16], ray_o / ray_d [T, P, 3] -> alpha [T, K, P]
    (Fwd.cu:228-241 per-pixel gaussian evaluation)."""
    mean, quat, inv_s, opac = f[..., 0:3], f[..., 3:7], f[..., 7:10], f[..., 10]
    rot = quat_to_rotmat(quat)
    # M = diag(1/s) R^T: rows m_i = inv_s[i] R[:, i]
    m = inv_s[..., :, None] * rot.transpose(-1, -2)  # [T, K, 3, 3]
    o_rel = ray_o[:, None, :, :] - mean[:, :, None, :]  # [T, K, P, 3]
    # 3-term matvecs as explicit sums (float32, no TF32)
    gro = (m[:, :, None, :, :] * o_rel[..., None, :]).sum(-1)  # [T, K, P, 3]
    grd = (m[:, :, None, :, :] * ray_d[:, None, :, None, :]).sum(-1)
    n2 = (grd * grd).sum(-1)
    cr = torch.linalg.cross(grd, gro, dim=-1)
    dist = (cr * cr).sum(-1) / torch.clamp(n2, min=1e-18)
    alpha = torch.clamp(opac[..., None] * torch.exp(-0.5 * dist), max=MAX_FRAGMENT_ALPHA)
    return torch.where(alpha >= MIN_ALPHA_THRESHOLD, alpha, 0.0)


def _blend_group(featw, ro, rd, g, in_range, n_channels):
    """One group of tiles: gather its instances' features [t, K, 16] (out
    of range: opacity 0), then the alphas and the blend -> (colour [t, P,
    C], T_final [t, P])."""
    f = featw[g]
    f = torch.cat([f[..., :10], torch.where(in_range, f[..., 10], 0.0)[..., None], f[..., 11:]], -1)
    alphas = _alphas_world(f, ro, rd)
    return blend_along_axis(alphas, f[..., 11:11 + n_channels])


def world_blend_tiles(
    featw: torch.Tensor,  # [N, 16] per-gaussian features (pack_world_features)
    rays_o: torch.Tensor,  # [Hp*Wp, 3]
    rays_d: torch.Tensor,  # [Hp*Wp, 3]
    assignment,  # ops.tiles.TileAssignment
    *,
    grid_w: int,
    grid_h: int,
    tile_size: int,
    n_channels: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense world-space blend of every binned instance: (image [Hp, Wp,
    C], alpha [Hp, Wp]). Tiles go in groups whose [t, K, P] intermediates
    stay bounded; K is each group's deepest tile, so nothing is cut.
    Differentiable with respect to featw, rays_o and rays_d; under
    autograd each group is recomputed in the backward."""
    ts = tile_size
    n_pix = ts * ts
    num_tiles = grid_w * grid_h

    def tile_major(x):
        return x.reshape(grid_h, ts, grid_w, ts, 3).transpose(1, 2).reshape(num_tiles, n_pix, 3)

    ro, rd = tile_major(rays_o), tile_major(rays_d)
    recompute = torch.is_grad_enabled() and any(
        t.requires_grad for t in (featw, rays_o, rays_d))
    colors, t_fins = [], []
    for t0, t1, k_max in _plain_groups(assignment.tile_count, n_pix):
        _, in_range, g, _, _, _ = _gather_group(
            t0, t1, k_max, assignment.tile_start, assignment.tile_count,
            assignment.gaussian_idx, grid_w, ts)
        args = (featw, ro[t0:t1], rd[t0:t1], g, in_range, n_channels)
        if recompute:
            c, t_fin = checkpoint(_blend_group, *args, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            c, t_fin = _blend_group(*args)
        colors.append(c)
        t_fins.append(t_fin)
    image = _untile(torch.cat(colors), grid_w, grid_h, ts)
    alpha = 1.0 - _untile(torch.cat(t_fins), grid_w, grid_h, ts)
    return image, alpha
