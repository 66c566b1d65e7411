"""Plain PyTorch reference of the 3DGS step the benchmark checks: EWA
projection with SH colour, binning into 32-px tiles with the exact tile
test, the depth-ordered alpha blend (forward, and its gradient with the
tail trim), L1 + SSIM and the regularisers, Adam and MCMC's noise.

It follows the published semantics (fastgs / gsplat preprocess and blend,
"3DGS as MCMC", LichtFeld-Studio's trainer) as the program states them,
and imports nothing of the program. Everything is float32 and elementwise
or a float32 contraction with TF32 off; `precision(True)` turns TF32 on
for the contractions (the blend's colour sum and the SSIM blur), which is
the check's control. Memory stays bounded: the blend walks groups of
tiles, and its gradient recomputes each group under autograd.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch

# rendering constants (fastgs rasterization_config.h)
DILATION = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_DONE = 1e-4
NEAR, FAR = 0.01, 1e10
INFERENCE_STOP = 1.0 / 512.0  # a frame's pixel stops once T falls below
TRIM_EPS = 1.0 / 255.0  # the gradient's tail trim (below)
TRIM_WINDOW = 128
GROUP_ELEMS = 1 << 25  # tiles x depth x pixels of one blend group

SH_C0 = 0.28209479177387814
_C1 = 0.48860251190291987
_C2 = (1.0925484305920792, -1.0925484305920792, 0.94617469575755997,
       -0.31539156525251999, 0.54627421529603959)
_C3 = (0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
       0.3731763325901154, 1.4453057213202769)


@contextmanager
def precision(tf32: bool):
    """TF32 on or off for matmuls and convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@dataclass
class View:
    """A view: world-to-camera R [3, 3], T [3] (float32), intrinsics, and
    the camera model ("PINHOLE" or "OPENCV_FISHEYE" with its radial k1-k4)."""

    R: torch.Tensor
    T: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    model: str = "PINHOLE"
    radial: tuple = ()

    @property
    def position(self) -> torch.Tensor:
        return -(self.R.T @ self.T)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation of an unnormalised wxyz quaternion, s = 2 / |q|^2."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.clamp(w * w + x * x + y * y + z * z, min=1e-24)
    xx, yy, zz, xy, xz, yz = s * x * x, s * y * y, s * z * z, s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return torch.stack([1.0 - (yy + zz), xy - wz, wy + xz,
                        wz + xy, 1.0 - (xx + zz), yz - wx,
                        xz - wy, wx + yz, 1.0 - (xx + yy)], dim=-1).reshape(q.shape[:-1] + (3, 3))


def sh_color(sh0, shN, means, cam_pos):
    """RGB of SH degree 3 (all bases active), unclamped: 0.5 + C0 sh0 + ..."""
    color = 0.5 + SH_C0 * sh0[:, 0, :]
    d = means - cam_pos[None, :]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    x, y, z = d.unbind(-1)
    xx, yy, zz, xy, xz, yz = x * x, y * y, z * z, x * y, x * z, y * z
    bases = torch.stack([
        -_C1 * y, _C1 * z, -_C1 * x,
        _C2[0] * xy, _C2[1] * yz, _C2[2] * zz + _C2[3], -_C2[0] * xz, _C2[4] * (xx - yy),
        _C3[0] * y * (-3.0 * xx + yy), _C3[1] * xy * z, _C3[2] * y * (1.0 - 5.0 * zz),
        _C3[3] * z * (5.0 * zz - 3.0), _C3[2] * x * (1.0 - 5.0 * zz), _C3[4] * z * (xx - yy),
        _C3[0] * x * (-xx + 3.0 * yy),
    ], dim=-1)[:, :shN.shape[1]]
    return color + (bases[:, :, None] * shN).sum(1)


@dataclass
class Projected:
    mean2d: torch.Tensor  # [N, 2]
    conic: torch.Tensor  # [N, 3]
    opacity: torch.Tensor  # [N]
    color: torch.Tensor  # [N, 3]
    depth: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] bool
    bbox: torch.Tensor  # [N, 4] int64 tile bounds x0, x1, y0, y1 (ends exclusive)
    cells: torch.Tensor  # [N, E] bool: the exact test on the first E bbox cells
    exact: torch.Tensor  # [N] bool: the exact test applies (bbox area <= E)


def _tile_index(v: torch.Tensor, hi: int) -> torch.Tensor:
    v = torch.nan_to_num(v, nan=0.0, posinf=float(hi), neginf=0.0)
    return torch.clamp(v, 0.0, float(hi)).to(torch.int64)


def _touches(mx, my, a, b, c, tx, ty, power_thr, ts):
    """Whether the gaussian's largest power over the tile's rectangle
    reaches the alpha threshold (fastgs will_primitive_contribute)."""
    rx0 = (tx * ts).to(torch.float32)
    ry0 = (ty * ts).to(torch.float32)
    rx1, ry1 = rx0 + (ts - 1), ry0 + (ts - 1)
    left, above = rx0 - mx > 0, ry0 - my > 0
    not_x = left.float() + (mx > rx1).float()
    not_y = above.float() + (my > ry1).float()
    inside = (not_x + not_y) == 0
    cx = torch.where(left, rx0, rx1)
    cy = torch.where(above, ry0, ry1)
    dxr, dyr = mx - cx, my - cy
    span = float(ts - 1)
    sx = torch.where(left, span, -span)
    sy = torch.where(above, span, -span)
    t_x = not_y * torch.clamp((sx * a * dxr + sx * b * dyr) / (sx * a * sx), 0.0, 1.0)
    t_y = not_x * torch.clamp((sy * b * dxr + sy * c * dyr) / (sy * c * sy), 0.0, 1.0)
    dx, dy = mx - (cx + t_x * sx), my - (cy + t_y * sy)
    power = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    return inside | (power <= power_thr)


def project(params: dict, view: View, tile_size: int, exact_cells: int = 16) -> Projected:
    """EWA projection (frustum-clamped Jacobian, +0.3 px dilation), the
    culls, SH colour and the tile footprint of every gaussian."""
    means, log_s, quats = params["means"], params["scaling"], params["rotation"]
    op_logit = params["opacity"][:, 0]
    R, T = view.R, view.T
    p = means[:, 0:1] * R[:, 0] + means[:, 1:2] * R[:, 1] + means[:, 2:3] * R[:, 2] + T
    depth = p[:, 2]
    valid = (depth >= NEAR) & (depth <= FAR)
    opacity = torch.sigmoid(op_logit)
    valid &= opacity >= ALPHA_MIN
    valid &= (quats * quats).sum(-1) >= 1e-8
    rot = quat_to_rotmat(quats)
    var = torch.exp(2.0 * log_s)
    zs = torch.where(depth.abs() > 1e-12, depth, torch.full_like(depth, 1e-12))
    x, y = p[:, 0] / zs, p[:, 1] / zs
    w, h = view.width, view.height
    tx = torch.clamp(x, (-0.15 * w - view.cx) / view.fx, (1.15 * w - view.cx) / view.fx)
    ty = torch.clamp(y, (-0.15 * h - view.cy) / view.fy, (1.15 * h - view.cy) / view.fy)
    j11, j22 = view.fx / zs, view.fy / zs
    j13, j23 = -j11 * tx, -j22 * ty
    jw1 = j11[:, None] * R[0][None, :] + j13[:, None] * R[2][None, :]
    jw2 = j22[:, None] * R[1][None, :] + j23[:, None] * R[2][None, :]
    u1 = (jw1[:, :, None] * rot).sum(1)
    u2 = (jw2[:, :, None] * rot).sum(1)
    cxx = (var * u1 * u1).sum(-1) + DILATION
    cxy = (var * u1 * u2).sum(-1)
    cyy = (var * u2 * u2).sum(-1) + DILATION
    det = cxx * cyy - cxy * cxy
    valid &= det >= 1e-8
    sdet = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    conic = torch.stack([cyy / sdet, -cxy / sdet, cxx / sdet], dim=-1)
    mean2d = torch.stack([x * view.fx + view.cx, y * view.fy + view.cy], dim=-1)
    color = sh_color(params["sh0"], params["shN"], means, view.position)
    return footprint(mean2d, conic, cxx, cyy, opacity, color, depth, valid, view, tile_size,
                     exact=True, exact_cells=exact_cells)


def footprint(mean2d, conic, cxx, cyy, opacity, color, depth, valid, view: View, tile_size: int,
              *, exact: bool, exact_cells: int = 16) -> Projected:
    """Screen bounds in tiles (extent from the alpha threshold's power),
    and with `exact` the exact tile test on the first `exact_cells` cells
    of a bounding box that small."""
    w, h = view.width, view.height
    with torch.no_grad():
        gw, gh = -(-w // tile_size), -(-h // tile_size)
        thr = torch.log(torch.clamp(opacity, min=ALPHA_MIN) * 255.0)
        ptf = torch.sqrt(torch.clamp(2.0 * thr, min=0.0))
        ex = torch.clamp(ptf * torch.sqrt(torch.clamp(cxx, min=0.0)) - 0.5, min=0.0)
        ey = torch.clamp(ptf * torch.sqrt(torch.clamp(cyy, min=0.0)) - 0.5, min=0.0)
        m = mean2d.detach()
        x0 = _tile_index(torch.floor((m[:, 0] - ex) / tile_size), gw)
        x1 = _tile_index(torch.ceil((m[:, 0] + ex) / tile_size), gw)
        y0 = _tile_index(torch.floor((m[:, 1] - ey) / tile_size), gh)
        y1 = _tile_index(torch.ceil((m[:, 1] + ey) / tile_size), gh)
        bw = torch.clamp(x1 - x0, min=1)
        area = (x1 - x0) * (y1 - y0)
        valid = valid & (area > 0)
        if not exact:
            n = area.shape[0]
            return Projected(mean2d, conic, opacity, color, depth, valid,
                             torch.stack([x0, x1, y0, y1], dim=-1),
                             torch.zeros((n, 1), dtype=torch.bool, device=m.device),
                             torch.zeros(n, dtype=torch.bool, device=m.device))
        k = torch.arange(exact_cells, device=m.device)[None, :]
        cells = _touches((m[:, 0] - 0.5)[:, None], (m[:, 1] - 0.5)[:, None],
                         conic[:, 0:1].detach(), conic[:, 1:2].detach(), conic[:, 2:3].detach(),
                         x0[:, None] + k % bw[:, None], y0[:, None] + k // bw[:, None],
                         thr[:, None], tile_size) & (k < area[:, None])
        exact_mask = area <= exact_cells
        valid = valid & torch.where(exact_mask, cells.sum(1) > 0, area > 0)
    return Projected(mean2d, conic, opacity, color, depth, valid,
                     torch.stack([x0, x1, y0, y1], dim=-1), cells, exact_mask)


@dataclass
class Binning:
    gaussian: torch.Tensor  # [I] owner of each instance, sorted by (tile, depth)
    tile_start: torch.Tensor  # [T] first instance of each tile
    tile_count: torch.Tensor  # [T]
    grid_w: int
    grid_h: int
    tile_size: int

    @property
    def n_instances(self) -> int:
        return int(self.gaussian.shape[0])


def bin_tiles(pr: Projected, width: int, height: int, tile_size: int, *,
              frame_order: bool = False) -> Binning:
    """Every (tile, gaussian) pair the footprint test keeps, sorted by
    tile and then by depth. `frame_order` is the renderer's stated order
    for frames: one 31-bit key a pair, the tile above the top 31 - b bits
    of the float32 depth (b the bits that hold the tile count, as long as
    12 or more depth bits remain), pairs of equal keys in gaussian order."""
    gw, gh = -(-width // tile_size), -(-height // tile_size)
    dev = pr.depth.device
    x0, x1, y0, y1 = pr.bbox.unbind(-1)
    bw = torch.clamp(x1 - x0, min=1)
    area = (x1 - x0) * (y1 - y0)
    n_cells = torch.where(pr.valid, area, 0)
    owner = torch.repeat_interleave(torch.arange(n_cells.shape[0], device=dev), n_cells)
    first = torch.cumsum(n_cells, 0) - n_cells
    cell = torch.arange(owner.shape[0], device=dev) - first[owner]
    e = pr.cells.shape[1]
    keep = ~pr.exact[owner] | pr.cells[owner, torch.clamp(cell, max=e - 1)]
    owner, cell = owner[keep], cell[keep]
    tile = (y0[owner] + cell // bw[owner]) * gw + x0[owner] + cell % bw[owner]
    d = pr.depth.detach()[owner]
    keep_bits = 31 - (gw * gh).bit_length()
    if frame_order and keep_bits >= 12:
        bits = d.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        d = bits >> (31 - keep_bits)
    order = torch.argsort(d, stable=True)
    order = order[torch.argsort(tile[order], stable=True)]
    owner, tile = owner[order], tile[order]
    count = torch.bincount(tile, minlength=gw * gh)
    start = torch.cumsum(count, 0) - count
    return Binning(owner, start, count, gw, gh, tile_size)


def _groups(count: torch.Tensor, n_pix: int, elems: int = GROUP_ELEMS):
    """Tiles in order of depth, deepest first, cut into groups whose
    tiles x depth x pixels stays under `elems`: (tile ids, depth)."""
    order = torch.argsort(count, descending=True, stable=True)
    cnt = count[order].tolist()
    i = 0
    while i < len(cnt):
        k = max(cnt[i], 1)
        m = max(1, elems // (k * n_pix))
        yield order[i:i + m], k
        i += m


def _gather(b: Binning, tiles: torch.Tensor, k: int):
    dev = tiles.device
    ts = b.tile_size
    kk = torch.arange(k, device=dev)
    pos = b.tile_start[tiles, None] + kk[None, :]
    in_range = kk[None, :] < b.tile_count[tiles, None]
    g = b.gaussian[torch.clamp(pos, max=max(b.n_instances - 1, 0))] if b.n_instances else \
        torch.zeros_like(pos)
    p = torch.arange(ts * ts, device=dev)
    px = ((tiles % b.grid_w) * ts)[:, None] + (p % ts)[None, :]
    py = ((tiles // b.grid_w) * ts)[:, None] + (p // ts)[None, :]
    return g, in_range, pos, px.float() + 0.5, py.float() + 0.5


def _alphas(m2d, conic, op, in_range, px, py):
    """[t, K, P] alphas with the blend's skips: 0 where the power is
    negative or alpha < 1/255, clamped at 0.999."""
    dx = m2d[:, :, None, 0] - px[:, None, :]
    dy = m2d[:, :, None, 1] - py[:, None, :]
    a, b, c = conic[:, :, None, 0], conic[:, :, None, 1], conic[:, :, None, 2]
    s = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = torch.clamp(torch.where(in_range, op, 0.0)[:, :, None] * torch.exp(-torch.clamp(s, min=0.0)),
                        max=ALPHA_MAX)
    return torch.where((s >= 0) & (alpha >= ALPHA_MIN), alpha, 0.0)


def _composite(alpha, color, stop: float):
    """(colour [t, P, 3], T_final [t, P], cumprod [t, K, P]). A term counts
    while T after it stays >= 1e-4 (and, for frames, T before it >= stop)."""
    cum = torch.cumprod(1.0 - alpha, dim=1)
    before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    counted = cum >= T_DONE
    if stop > 0:
        counted &= before >= stop
    w = torch.where(counted, before * alpha, 0.0)
    col = torch.einsum("tkp,tkc->tpc", w, torch.clamp(color, min=0.0))
    t_final = torch.where(counted, 1.0 - alpha, 1.0).prod(dim=1)
    return col, t_final, cum


def _trim_keep(cum, start, count, eps: float):
    """[t] instances of each tile the gradient keeps: those before window
    neff of the GLOBAL sorted order (128-instance windows, the first
    partial), where neff is 1 + the last window in which some pixel's
    transmittance falls by eps or more. A pixel's transmittance stops at
    the term that takes it below 1e-4 (that term included)."""
    t, kmax, p = cum.shape
    kk = torch.arange(kmax, device=cum.device)
    crossed = cum < T_DONE
    kc = torch.where(crossed.any(1), crossed.float().argmax(1), kmax - 1)  # [t, P]
    t_after = torch.gather(cum, 1, torch.minimum(kk[None, :, None], kc[:, None, :]))
    off = start % TRIM_WINDOW
    n_win = (kmax + TRIM_WINDOW - 1) // TRIM_WINDOW + 1
    w = torch.arange(n_win, device=cum.device)
    k_first = torch.clamp(w[None, :] * TRIM_WINDOW - off[:, None], min=0)  # [t, W]
    k_last = torch.minimum((w[None, :] + 1) * TRIM_WINDOW - off[:, None], count[:, None]) - 1
    live = (k_first < count[:, None]) & (k_last >= k_first)
    exit_ = torch.gather(t_after, 1, torch.clamp(k_last, 0, kmax - 1)[:, :, None].expand(-1, -1, p))
    entry = torch.where((k_first == 0)[:, :, None], torch.ones_like(exit_),
                        torch.gather(t_after, 1, torch.clamp(k_first - 1, 0, kmax - 1)[:, :, None]
                                     .expand(-1, -1, p)))
    heavy = live & ((entry - exit_).amax(-1) >= eps)
    last = torch.where(heavy, w[None, :], -1).amax(1)
    neff = torch.clamp(last + 1, min=1)
    return torch.clamp(TRIM_WINDOW * neff - off, max=count)


def render(pr: Projected, b: Binning, width: int, height: int, *, stop: float = 0.0,
           tf32: bool = False):
    """Forward blend without gradient: (image [H, W, 3], alpha [H, W])."""
    ts, n_pix = b.tile_size, b.tile_size ** 2
    t_all = b.grid_w * b.grid_h
    col_t = torch.zeros((t_all, n_pix, 3), device=pr.depth.device)
    tf_t = torch.ones((t_all, n_pix), device=pr.depth.device)
    with torch.no_grad(), precision(tf32):
        for tiles, k in _groups(b.tile_count, n_pix):
            g, in_range, _, px, py = _gather(b, tiles, k)
            a = _alphas(pr.mean2d[g], pr.conic[g], pr.opacity[g], in_range, px, py)
            col, tfin, _ = _composite(a, pr.color[g], stop)
            col_t[tiles], tf_t[tiles] = col, tfin
    return _image(col_t, b, width, height), _image(1.0 - tf_t, b, width, height)


def _image(x, b: Binning, width, height):
    ts = b.tile_size
    rest = x.shape[2:]
    x = x.reshape(b.grid_h, b.grid_w, ts, ts, *rest).transpose(1, 2)
    return x.reshape(b.grid_h * ts, b.grid_w * ts, *rest)[:height, :width]


def _tiles_of(img, b: Binning):
    """[H, W, ...] -> per-tile pixels [T, P, ...] (zero padded)."""
    ts = b.tile_size
    hp, wp = b.grid_h * ts, b.grid_w * ts
    pad = torch.zeros((hp, wp) + img.shape[2:], dtype=img.dtype, device=img.device)
    pad[:img.shape[0], :img.shape[1]] = img
    rest = img.shape[2:]
    x = pad.reshape(b.grid_h, ts, b.grid_w, ts, *rest).transpose(1, 2)
    return x.reshape(b.grid_h * b.grid_w, ts * ts, *rest)


def blend_grads(pr: Projected, b: Binning, d_image, d_alpha, *, trim_eps: float = TRIM_EPS,
                tf32: bool = False):
    """Per-gaussian gradients of the blend (d mean2d [N, 2], d conic [N, 3],
    d opacity [N], d colour [N, 3]) for the cotangents of the image and
    the alpha map: each group recomputed under autograd, the rows of the
    instances past the tail trim zeroed, summed per gaussian in float64."""
    n = pr.depth.shape[0]
    dev = pr.depth.device
    out = torch.zeros((n, 9), dtype=torch.float64, device=dev)
    gi, ga = _tiles_of(d_image, b), _tiles_of(d_alpha, b)
    n_pix = b.tile_size ** 2
    leaves_src = (pr.mean2d.detach(), pr.conic.detach(), pr.opacity.detach(), pr.color.detach())
    with precision(tf32):
        for tiles, k in _groups(b.tile_count, n_pix):
            g, in_range, _, px, py = _gather(b, tiles, k)
            leaves = [x[g].requires_grad_(True) for x in leaves_src]
            with torch.enable_grad():
                a = _alphas(leaves[0], leaves[1], leaves[2], in_range, px, py)
                col, tfin, cum = _composite(a, leaves[3], 0.0)
                grads = torch.autograd.grad((col, tfin), leaves, (gi[tiles], -ga[tiles]))
            rows = torch.cat([grads[0], grads[1], grads[2][..., None], grads[3]], dim=-1)
            keep = in_range
            if trim_eps > 0:
                kept = _trim_keep(cum.detach(), b.tile_start[tiles], b.tile_count[tiles], trim_eps)
                keep = keep & (torch.arange(k, device=dev)[None, :] < kept[:, None])
            out.index_add_(0, g[keep], rows[keep].to(torch.float64))
    out = out.to(torch.float32)
    return out[:, 0:2], out[:, 2:5], out[:, 5], out[:, 6:9]


# ----------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------
def _band(n: int, device) -> torch.Tensor:
    """[n, n - 10]: column j holds the 11-tap Gaussian (sigma 1.5) at rows
    j..j+10, so x @ band is the valid 1-D blur of x's rows."""
    x = torch.arange(11, dtype=torch.float32, device=device) - 5
    g = torch.exp(-(x ** 2) / (2.0 * 1.5 ** 2))
    g = g / g.sum()
    band = torch.zeros((n, n - 10), dtype=torch.float32, device=device)
    j = torch.arange(n - 10, device=device)
    for k in range(11):
        band[j + k, j] = g[k]
    return band


def _blur_valid(img: torch.Tensor) -> torch.Tensor:
    """Separable 11-tap Gaussian blur, valid padding ([H, W, C] -> [H-10,
    W-10, C]), as two float32 contractions with banded matrices (with TF32
    on, the control's, they round their inputs to ten mantissa bits)."""
    h, w = img.shape[0], img.shape[1]
    t = img.permute(2, 0, 1)  # [C, H, W]
    t = t @ _band(w, img.device)  # along rows
    t = _band(h, img.device).T @ t  # along columns
    return t.permute(1, 2, 0)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = _blur_valid(a), _blur_valid(b)
    s11 = _blur_valid(a * a) - mu1 * mu1
    s22 = _blur_valid(b * b) - mu2 * mu2
    s12 = _blur_valid(a * b) - mu1 * mu2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def photometric(img, gt, lambda_dssim: float):
    return (1.0 - lambda_dssim) * (img - gt).abs().mean() + lambda_dssim * (1.0 - ssim(img, gt))


# ----------------------------------------------------------------------
# One MCMC train step
# ----------------------------------------------------------------------
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-15
NOISE_LR = 5e5
GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")


def step_grads(params: dict, view: View, gt: torch.Tensor, cfg: dict, *, tf32: bool = False,
               half: bool = False):
    """(loss, per-group gradients) of one view: render (EWA and the 2D
    blend, or with cfg["gut_exact"] the UT projection and the world-space
    blend of reference/world.py), L1 + SSIM, the scale and opacity
    regularisers over every gaussian (all are live at the cap), gradients
    through the blend and then the projection. `half` plants a fault for
    the check's own test: the photometric mean over the top half of the
    image alone."""
    from port_bench.reference import world

    ts = cfg["tile_size"]
    exact = cfg["gut_exact"]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    pr = (world.project_ut if exact else project)(leaves, view, ts)
    b = bin_tiles(pr, view.width, view.height, ts)
    if exact:
        feat, rays = world.features(leaves, pr), world.world_rays(view, ts)
        img, alpha = world.render(feat.detach(), rays, b, view.width, view.height, tf32=tf32)
    else:
        img, alpha = render(pr, b, view.width, view.height, tf32=tf32)
    img = img.detach().requires_grad_(True)
    rows = view.height // 2 if half else view.height
    with precision(tf32):
        photo = photometric(img[:rows], gt[:rows], cfg["lambda_dssim"])
        (d_img,) = torch.autograd.grad(photo, img)
    reg = (cfg["scale_reg"] * torch.exp(leaves["scaling"]).mean()
           + cfg["opacity_reg"] * torch.sigmoid(leaves["opacity"]).mean())
    if exact:
        g_feat = world.blend_grads(feat, rays, b, d_img, torch.zeros_like(alpha), tf32=tf32)
        torch.autograd.backward([feat, reg], [g_feat, torch.ones_like(reg)])
    else:
        g_m2d, g_conic, g_op, g_col = blend_grads(pr, b, d_img, torch.zeros_like(alpha),
                                                  tf32=tf32)
        torch.autograd.backward([pr.mean2d, pr.conic, pr.opacity, pr.color, reg],
                                [g_m2d, g_conic, g_op, g_col, torch.ones_like(reg)])
    grads = {k: leaves[k].grad for k in GROUPS}
    return (photo.detach() + reg.detach()), grads, b.n_instances


@torch.no_grad()
def mcmc_noise(params: dict, noise: torch.Tensor, lr_means: torch.Tensor) -> torch.Tensor:
    """means + lr 5e5 sigmoid(-100 (opacity - 0.005)) R S^2 R^T n."""
    rot = quat_to_rotmat(params["rotation"])
    var = torch.exp(2.0 * params["scaling"])
    t = (rot * noise[:, :, None]).sum(1)
    moved = (rot * (var * t)[:, None, :]).sum(2)
    gate = torch.sigmoid(-(100.0 * torch.sigmoid(params["opacity"][:, 0]) - 0.5))
    return params["means"] + (lr_means * NOISE_LR * gate)[:, None] * moved


@torch.no_grad()
def adam(params: dict, grads: dict, m: dict, v: dict, t: int, lrs: dict):
    """One Adam step at step count t (1-based) for every group: new
    (params, m, v)."""
    out_p, out_m, out_v = {}, {}, {}
    for k in GROUPS:
        tt = torch.tensor(float(t), device=params[k].device)
        step = lrs[k] * torch.sqrt(1.0 - BETA2 ** tt) / (1.0 - BETA1 ** tt)
        out_m[k] = BETA1 * m[k] + (1.0 - BETA1) * grads[k]
        out_v[k] = BETA2 * v[k] + (1.0 - BETA2) * grads[k] * grads[k]
        out_p[k] = params[k] - step * out_m[k] / (torch.sqrt(out_v[k]) + ADAM_EPS)
    return out_p, out_m, out_v


def lr_schedule(cfg: dict, scene_scale: float = 1.0) -> dict:
    """Per-group learning rates at the window's start iteration: the means
    group decays by 0.01 ** (1 / iterations) a step from its start."""
    gamma = 0.01 ** (1.0 / cfg["iterations"])
    return {
        "means": cfg["means_lr"] * scene_scale * gamma ** cfg["start_iteration"],
        "sh0": cfg["shs_lr"], "shN": cfg["shs_lr"] / 20.0, "scaling": cfg["scaling_lr"],
        "rotation": cfg["rotation_lr"], "opacity": cfg["opacity_lr"],
    }


def train_steps(params: dict, views: list[View], gts: list[torch.Tensor], cfg: dict,
                noise_gen: torch.Generator, *, tf32: bool = False, half: bool = False):
    """The first len(views) steps from `params` with fresh Adam moments:
    (losses, gradient of step 1, params after the last step, instances of
    each step). Noise is drawn from `noise_gen` as one [N, 3] standard
    normal a step, after the gradient and before Adam."""
    dev = params["means"].device
    lr0 = lr_schedule(cfg)
    gamma = 0.01 ** (1.0 / cfg["iterations"])
    lrs = {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in lr0.items()}
    m = {k: torch.zeros_like(params[k]) for k in GROUPS}
    v = {k: torch.zeros_like(params[k]) for k in GROUPS}
    p = {k: params[k].clone() for k in GROUPS}
    losses, first, counts = [], None, []
    for i, (view, gt) in enumerate(zip(views, gts)):
        loss, grads, n_inst = step_grads(p, view, gt, cfg, tf32=tf32, half=half)
        losses.append(float(loss))
        counts.append(n_inst)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        noise = torch.randn((p["means"].shape[0], 3), generator=noise_gen, device=dev)
        p = dict(p, means=mcmc_noise(p, noise, lrs["means"]))
        p, m, v = adam(p, grads, m, v, i + 1, lrs)
        lrs["means"] = lrs["means"] * gamma
    return losses, first, p, counts
