"""Plain PyTorch reference of the 3DGUT step (`--gut-exact`) for a global
shutter pinhole or OPENCV_FISHEYE camera: the unscented-transform
projection (seven sigma points through the camera model) that bins each
gaussian on its full screen bounds, every pixel's world ray, and the exact
world-space blend: each 3D gaussian evaluated at its closest approach to
the ray in the gaussian's normalised frame,

    M = diag(1/s) R^T,  gro = M (o - mean),  grd = M d
    dist = |grd x gro|^2 / |grd|^2,  alpha = min(0.999, opacity exp(-dist / 2))

kept where alpha >= 1/255, composited front to back in depth order (3DGUT,
Wu et al. 2024; gsplat's RasterizeToPixelsFromWorld3DGS). It imports
nothing of the program; the loss, Adam and noise are raster.py's.
"""

from __future__ import annotations


import torch

from port_bench.reference import raster

UT_ALPHA, UT_BETA, UT_KAPPA, UT_MARGIN, EPS2D = 0.1, 2.0, 0.0, 0.1, 0.3
GROUP_ELEMS = 1 << 24  # tiles x depth x pixels of one world-blend group


def _fisheye(x, y, z, k):
    """Equidistant fisheye with the theta polynomial: normalised image coords."""
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8), torch.ones_like(r))
    return x * scale, y * scale


def _radial(view: raster.View) -> list[float]:
    return (list(view.radial) + [0.0] * 4)[:4]


def _image_points(p, view: raster.View):
    """Camera-space points [..., 3] -> (image points [..., 2], valid [...])."""
    z = p[..., 2]
    if view.model == "OPENCV_FISHEYE":
        x, y = _fisheye(p[..., 0], p[..., 1], z, _radial(view))
        ok = z > 1e-8
    else:
        zs = torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))
        x, y = p[..., 0] / zs, p[..., 1] / zs
        ok = z > 0
    u, v = x * view.fx + view.cx, y * view.fy + view.cy
    w, h = view.width, view.height
    ok = ok & (u >= -UT_MARGIN * w) & (u <= (1 + UT_MARGIN) * w) & (v >= -UT_MARGIN * h) \
        & (v <= (1 + UT_MARGIN) * h)
    return torch.stack([u, v], dim=-1), ok


def _ordered_sum(x):
    out = x[0]
    for k in range(1, x.shape[0]):
        out = out + x[k]
    return out


def project_ut(params: dict, view: raster.View, tile_size: int) -> raster.Projected:
    """UT projection: the sigma points' weighted mean and covariance (+0.3
    px) give the image mean and conic; the footprint is the full screen
    bounds (no exact tile test: the world-space footprint is not the
    conic's)."""
    means, log_s, quats = params["means"], params["scaling"], params["rotation"]
    R, T = view.R, view.T
    pc = means[:, 0:1] * R[:, 0] + means[:, 1:2] * R[:, 1] + means[:, 2:3] * R[:, 2] + T
    depth = pc[:, 2]
    valid = (depth >= raster.NEAR) & (depth <= raster.FAR)
    opacity = torch.sigmoid(params["opacity"][:, 0])
    valid &= opacity >= raster.ALPHA_MIN
    valid &= (quats * quats).sum(-1) >= 1e-8
    d = 3.0
    lam = UT_ALPHA ** 2 * (d + UT_KAPPA) - d
    rot = raster.quat_to_rotmat(quats)
    deltas = ((d + lam) ** 0.5 * torch.exp(log_s)[:, None, :] * rot).transpose(1, 2)
    m = means[:, None, :]
    pts = torch.cat([m, m + deltas, m - deltas], dim=1)  # [N, 7, 3]
    w_mean = torch.tensor([lam / (d + lam)] + [1.0 / (2.0 * (d + lam))] * 6,
                          dtype=torch.float32, device=means.device)
    w_cov = w_mean.clone()
    w_cov[0] += 1.0 - UT_ALPHA ** 2 + UT_BETA
    p = pts[..., 0:1] * R[:, 0] + pts[..., 1:2] * R[:, 1] + pts[..., 2:3] * R[:, 2] + T
    img, ok = _image_points(p, view)
    valid &= ok.all(dim=1)
    mean2d = _ordered_sum(w_mean[:, None, None] * img.transpose(0, 1))
    dev = img - mean2d[:, None, :]
    cov = _ordered_sum(w_cov[:, None, None, None]
                       * (dev[..., :, None] * dev[..., None, :]).transpose(0, 1))
    cxx, cxy, cyy = cov[:, 0, 0] + EPS2D, cov[:, 0, 1], cov[:, 1, 1] + EPS2D
    det = cxx * cyy - cxy * cxy
    valid &= det >= 1e-8
    sdet = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    conic = torch.stack([cyy / sdet, -cxy / sdet, cxx / sdet], dim=-1)
    color = raster.sh_color(params["sh0"], params["shN"], means, view.position)
    return raster.footprint(mean2d, conic, cxx, cyy, opacity, color, depth, valid, view,
                            tile_size, exact=False)


def world_rays(view: raster.View, tile_size: int):
    """(origin [3], directions [T, P, 3]) of every pixel of the padded tile
    grid, tile-major, in world space."""
    dev = view.R.device
    gw, gh = -(-view.width // tile_size), -(-view.height // tile_size)
    ys, xs = torch.meshgrid(torch.arange(gh * tile_size, device=dev),
                            torch.arange(gw * tile_size, device=dev), indexing="ij")
    u = (xs.float() + 0.5 - view.cx) / view.fx
    v = (ys.float() + 0.5 - view.cy) / view.fy
    if view.model == "OPENCV_FISHEYE":
        k = _radial(view)
        delta = torch.sqrt(u * u + v * v)
        theta = delta
        for _ in range(10):  # Newton on theta (1 + k1 t^2 + ...) = delta
            t2 = theta * theta
            f = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))) - delta
            df = 1.0 + t2 * (3.0 * k[0] + t2 * (5.0 * k[1] + t2 * (7.0 * k[2] + t2 * 9.0 * k[3])))
            theta = theta - f / torch.where(df.abs() > 1e-9, df, torch.full_like(df, 1e-9))
        s = torch.where(delta > 1e-8, torch.sin(theta) / torch.clamp(delta, min=1e-8),
                        torch.ones_like(delta))
        d = torch.stack([s * u, s * v, torch.cos(theta)], -1)
    else:
        d = torch.stack([u, v, torch.ones_like(u)], -1)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = (d.reshape(-1, 3)[:, :, None] * view.R[None, :, :]).sum(1)  # R^T d
    d = d.reshape(gh, tile_size, gw, tile_size, 3).transpose(1, 2).reshape(gw * gh, -1, 3)
    return view.position, d


def features(params: dict, pr: raster.Projected) -> torch.Tensor:
    """[N, 14]: mean, unit quaternion, 1/scale, opacity, colour."""
    q = params["rotation"]
    qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([params["means"], qn, torch.exp(-params["scaling"]), pr.opacity[:, None],
                      pr.color], dim=-1)


def _alphas(f, in_range, origin, rd):
    """f [t, K, 14], rd [t, P, 3] -> alpha [t, K, P]. Per gaussian C =
    gro x M (row by row: C d = gro x (M d)) and M, so that a pixel's
    distance is |C d|^2 / |M d|^2, two float32 contractions over its ray."""
    rot = raster.quat_to_rotmat(f[..., 3:7])
    m = f[..., 7:10, None] * rot.transpose(-1, -2)  # rows 1/s_i R[:, i]
    gro = (m * (origin - f[..., 0:3])[..., None, :]).sum(-1)  # [t, K, 3]
    c = torch.linalg.cross(-m.transpose(-1, -2), gro[..., None, :].expand_as(m),
                           dim=-1).transpose(-1, -2)  # C d = gro x (M d) = -(M d) x gro
    md = torch.einsum("tkij,tpj->tkpi", m, rd)
    cd = torch.einsum("tkij,tpj->tkpi", c, rd)
    dist = (cd * cd).sum(-1) / torch.clamp((md * md).sum(-1), min=1e-18)
    op = torch.where(in_range, f[..., 10], 0.0)
    alpha = torch.clamp(op[..., None] * torch.exp(-0.5 * dist), max=raster.ALPHA_MAX)
    return torch.where(alpha >= raster.ALPHA_MIN, alpha, 0.0)


def _groups(b: raster.Binning):
    return raster._groups(b.tile_count, b.tile_size ** 2, GROUP_ELEMS)


def render(feat, rays, b: raster.Binning, width: int, height: int, *, tf32: bool = False):
    """Forward world blend without gradient: (image [H, W, 3], alpha [H, W])."""
    origin, rd = rays
    t_all, n_pix = b.grid_w * b.grid_h, b.tile_size ** 2
    col_t = torch.zeros((t_all, n_pix, 3), device=feat.device)
    tf_t = torch.ones((t_all, n_pix), device=feat.device)
    with torch.no_grad(), raster.precision(tf32):
        for tiles, k in _groups(b):
            g, in_range, _, _, _ = raster._gather(b, tiles, k)
            f = feat[g]
            col, tfin, _ = raster._composite(_alphas(f, in_range, origin, rd[tiles]),
                                             f[..., 11:14], 0.0)
            col_t[tiles], tf_t[tiles] = col, tfin
    return raster._image(col_t, b, width, height), raster._image(1.0 - tf_t, b, width, height)


def blend_grads(feat, rays, b: raster.Binning, d_image, d_alpha, *, tf32: bool = False):
    """d feat [N, 14] of the world blend for the image and alpha
    cotangents, each group recomputed under autograd, summed per gaussian
    in float64 (no tail trim: the world blend's gradient keeps every
    counted term)."""
    origin, rd = rays
    out = torch.zeros(feat.shape, dtype=torch.float64, device=feat.device)
    gi, ga = raster._tiles_of(d_image, b), raster._tiles_of(d_alpha, b)
    src = feat.detach()
    with raster.precision(tf32):
        for tiles, k in _groups(b):
            g, in_range, _, _, _ = raster._gather(b, tiles, k)
            f = src[g].requires_grad_(True)
            with torch.enable_grad():
                col, tfin, _ = raster._composite(_alphas(f, in_range, origin, rd[tiles]),
                                                 f[..., 11:14], 0.0)
                (gf,) = torch.autograd.grad((col, tfin), (f,), (gi[tiles], -ga[tiles]))
            out.index_add_(0, g[in_range], gf[in_range].to(torch.float64))
    return out.to(torch.float32)
