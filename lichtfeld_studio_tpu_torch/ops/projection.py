"""EWA perspective projection + screen-bounds preprocess (counterpart of
lichtfeld_studio_tpu/ops/projection.py; reference fastgs preprocess,
kernels_forward.cuh:18-205).

sigmoid(opacity) culling, cov2d from quat/scale through the frustum-clamped
EWA Jacobian, conic with +0.3 px dilation, SH -> RGB, conservative tile
bounds and the exact tile-overlap bitmask. Culling is a `valid` mask over
the static capacity, as in the JAX package. Everything stays float32 and
elementwise (no matmul, so TF32 never enters)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lichtfeld_studio_tpu_torch.ops.gaussians import quat_to_rotmat
from lichtfeld_studio_tpu_torch.ops.sh import sh_to_color

# Rendering constants (reference rasterization_config.h:12-30)
DILATION = 0.3
MIN_ALPHA_THRESHOLD_RCP = 255.0
MIN_ALPHA_THRESHOLD = 1.0 / MIN_ALPHA_THRESHOLD_RCP
MAX_FRAGMENT_ALPHA = 0.999
TRANSMITTANCE_THRESHOLD = 1e-4
NEAR_PLANE = 0.01
FAR_PLANE = 1e10

EXACT_TILE_CAP = 32


@dataclass
class ProjectedSplats:
    depth: torch.Tensor  # [C]
    mean2d: torch.Tensor  # [C, 2] pixel coords
    conic: torch.Tensor  # [C, 3] (a, b, c): a*dx^2 + 2b*dx*dy + c*dy^2
    opacity: torch.Tensor  # [C] activated (sigmoid)
    color: torch.Tensor  # [C, 3] SH-evaluated RGB (unclamped)
    bbox: torch.Tensor  # [C, 4] int32 tile bounds (x_min, x_max, y_min, y_max), max exclusive
    n_touched: torch.Tensor  # [C] int32 exact touched-tile count (0 for culled)
    valid: torch.Tensor  # [C] bool
    # Bitmask over the first exact_tile_cap bbox cells (row-major): bit k set
    # iff the gaussian contributes to that tile. 0 means "no exact mask" —
    # culled, or bbox larger than the cap (conservative full bbox).
    tile_mask: torch.Tensor  # [C] int32


def _will_contribute(mx, my, ca, cb, cc, tile_x, tile_y, power_threshold,
                     tile_size, rect_pad: float = 0.0):
    """Exact tile-overlap test (fastgs kernel_utils.cuh:108-143): the
    gaussian's largest power over the tile rect against the alpha-threshold
    power. Arguments broadcast to [K, C]."""
    rect_min_x = (tile_x * tile_size).to(torch.float32) - rect_pad
    rect_min_y = (tile_y * tile_size).to(torch.float32) - rect_pad
    rect_max_x = rect_min_x + (tile_size - 1) + 2.0 * rect_pad
    rect_max_y = rect_min_y + (tile_size - 1) + 2.0 * rect_pad

    x_min_diff = rect_min_x - mx
    x_left = (x_min_diff > 0).to(torch.float32)
    not_in_x = x_left + (mx > rect_max_x).to(torch.float32)
    y_min_diff = rect_min_y - my
    y_above = (y_min_diff > 0).to(torch.float32)
    not_in_y = y_above + (my > rect_max_y).to(torch.float32)

    inside = (not_in_x + not_in_y) == 0.0

    closest_x = rect_max_x + x_left * (rect_min_x - rect_max_x)
    closest_y = rect_max_y + y_above * (rect_min_y - rect_max_y)
    diff_x = mx - closest_x
    diff_y = my - closest_y
    span = float(tile_size - 1) + 2.0 * rect_pad
    d_x = torch.where(x_min_diff > 0, span, -span)
    d_y = torch.where(y_min_diff > 0, span, -span)
    t_x = not_in_y * torch.clamp((d_x * ca * diff_x + d_x * cb * diff_y) / (d_x * ca * d_x), 0.0, 1.0)
    t_y = not_in_x * torch.clamp((d_y * cb * diff_x + d_y * cc * diff_y) / (d_y * cc * d_y), 0.0, 1.0)
    pt_x = closest_x + t_x * d_x
    pt_y = closest_y + t_y * d_y
    dx = mx - pt_x
    dy = my - pt_y
    max_power = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    return inside | (max_power <= power_threshold)


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) for x >= 0 whose gradient is 0, not inf, at x = 0. The
    antialiasing compensation is exactly 0 where the un-dilated determinant
    is not positive (dead slots, degenerate footprints); d sqrt at 0 times
    the zero gradient of the clamp before it would be NaN, and one NaN
    gradient reaches every parameter of that slot through Adam (the JAX
    package's UT path does just that under --gut --antialiasing)."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)), 0.0)


def _tile_index(v: torch.Tensor, hi: int) -> torch.Tensor:
    """float -> int32 tile index clipped to [0, hi]. Clipping in float first
    gives XLA's saturating float->int conversion (NaN -> 0) instead of
    torch's undefined cast of out-of-range values."""
    v = torch.nan_to_num(v, nan=0.0, posinf=float(hi), neginf=0.0)
    return torch.clamp(v, 0.0, float(hi)).to(torch.int32)


def screen_bounds(
    mean2d: torch.Tensor,  # [C, 2]
    conic: torch.Tensor,  # [C, 3]
    c_xx: torch.Tensor,  # [C] dilated image covariance, xx
    c_yy: torch.Tensor,  # [C] and yy
    opacity: torch.Tensor,  # [C]
    valid: torch.Tensor,  # [C] bool
    *,
    width: int,
    height: int,
    tile_size: int,
    exact_tile_cap: int = EXACT_TILE_CAP,
    exact_tile_test: bool = True,
    dilate_px: float = 0.0,
):
    """Conservative tile bounds and the exact tile-overlap bitmask, shared by
    the EWA and the UT projection: (bbox [C, 4], n_touched [C], valid [C],
    tile_mask [C]). exact_tile_test=False keeps every gaussian on its full
    bbox (the world-space blend's footprint is not bounded by the conic).
    dilate_px > 0 bins every tile the gaussian could touch if its mean
    drifted up to dilate_px pixels: extents plus dilate_px, and the exact
    test against each tile rect padded by dilate_px (the frame-coherent
    renderer's bin pass, render/coherent.py). exact_tile_cap <= 0 is the
    feature-only mode: no exact test, n_touched = bbox area, tile_mask 0
    (the coherent renderer's frame pass, whose binning is cached)."""
    grid_w = -(-width // tile_size)
    grid_h = -(-height // tile_size)
    # --- conservative tile bounds (kernels_forward.cuh:160-177) ---
    power_threshold = torch.log(
        torch.clamp(opacity, min=MIN_ALPHA_THRESHOLD) * MIN_ALPHA_THRESHOLD_RCP
    )
    ptf = torch.sqrt(torch.clamp(2.0 * power_threshold, min=0.0))
    extent_x = torch.clamp(ptf * torch.sqrt(torch.clamp(c_xx, min=0.0)) - 0.5, min=0.0) + dilate_px
    extent_y = torch.clamp(ptf * torch.sqrt(torch.clamp(c_yy, min=0.0)) - 0.5, min=0.0) + dilate_px
    ts = float(tile_size)
    x_min = _tile_index(torch.floor((mean2d[:, 0] - extent_x) / ts), grid_w)
    x_max = _tile_index(torch.ceil((mean2d[:, 0] + extent_x) / ts), grid_w)
    y_min = _tile_index(torch.floor((mean2d[:, 1] - extent_y) / ts), grid_h)
    y_max = _tile_index(torch.ceil((mean2d[:, 1] + extent_y) / ts), grid_h)
    bb_w = x_max - x_min
    area = bb_w * (y_max - y_min)
    valid = valid & (area > 0)
    bbox = torch.stack([x_min, x_max, y_min, y_max], dim=-1)
    if exact_tile_cap <= 0:
        n_touched = torch.where(valid, area, 0).to(torch.int32)
        return bbox, n_touched, valid, torch.zeros_like(n_touched)

    # --- exact touched-tile count over the first exact_tile_cap bbox cells
    # (compute_exact_n_touched_tiles, kernel_utils.cuh:146-196, as a
    # [K, C] vectorised test) ---
    dev = mean2d.device
    k = torch.arange(exact_tile_cap, dtype=torch.int32, device=dev)[:, None]  # [K, 1]
    safe_w = torch.clamp(bb_w, min=1)[None, :]
    cand_x = x_min[None, :] + k % safe_w  # [K, C]
    cand_y = y_min[None, :] + k // safe_w
    in_bbox = k < area[None, :]
    contrib = _will_contribute(
        (mean2d[:, 0] - 0.5)[None, :],
        (mean2d[:, 1] - 0.5)[None, :],
        conic[:, 0][None, :],
        conic[:, 1][None, :],
        conic[:, 2][None, :],
        cand_x,
        cand_y,
        power_threshold[None, :],
        tile_size,
        rect_pad=dilate_px,
    )
    use_exact = (area <= exact_tile_cap) & valid
    if not exact_tile_test:
        use_exact = torch.zeros_like(use_exact)
    hit = in_bbox & contrib  # [K, C]
    # the bitmask is built in int64 and narrowed with two's-complement wrap,
    # so bit 31 lands on the int32 sign bit as in the JAX package
    bits = torch.where(hit, torch.ones((), dtype=torch.int64, device=dev) << k.long(), 0)
    mask64 = bits.sum(0)
    mask_all = torch.where(mask64 >= 2**31, mask64 - 2**32, mask64).to(torch.int32)
    tile_mask = torch.where(use_exact, mask_all, 0)
    n_exact = hit.sum(0, dtype=torch.int32)
    n_touched = torch.where(use_exact, n_exact, area)
    valid = valid & (n_touched > 0)
    n_touched = torch.where(valid, n_touched, 0).to(torch.int32)
    tile_mask = torch.where(valid, tile_mask, 0).to(torch.int32)
    return bbox, n_touched, valid, tile_mask


def project_gaussians(
    means: torch.Tensor,  # [C, 3]
    log_scales: torch.Tensor,  # [C, 3]
    quats: torch.Tensor,  # [C, 4] wxyz unnormalized
    logit_opacities: torch.Tensor,  # [C] or [C, 1]
    sh0: torch.Tensor,  # [C, 1, 3]
    shN: torch.Tensor,  # [C, K-1, 3]
    active_mask: torch.Tensor,  # [C] bool (live slots)
    active_sh_degree: torch.Tensor | int,
    w2c: torch.Tensor,  # [4, 4]
    cam_position: torch.Tensor,  # [3]
    K: torch.Tensor,  # [4] (fx, fy, cx, cy)
    *,
    width: int,
    height: int,
    tile_size: int = 16,
    near: float = NEAR_PLANE,
    far: float = FAR_PLANE,
    antialiasing: bool = False,
    exact_tile_cap: int = EXACT_TILE_CAP,
    dilate_px: float = 0.0,
) -> ProjectedSplats:
    """dilate_px and exact_tile_cap <= 0: see screen_bounds."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]

    if logit_opacities.ndim == 2:
        logit_opacities = logit_opacities[:, 0]

    # --- camera transform & z cull (kernels_forward.cuh:58-66), explicit
    # component sums in float32 ---
    rot_w2c = w2c[:3, :3]
    t_w2c = w2c[:3, 3]
    p_cam = (
        means[:, 0:1] * rot_w2c[:, 0][None, :]
        + means[:, 1:2] * rot_w2c[:, 1][None, :]
        + means[:, 2:3] * rot_w2c[:, 2][None, :]
        + t_w2c[None, :]
    )  # [C, 3]
    depth = p_cam[:, 2]
    valid = active_mask & (depth >= near) & (depth <= far)

    opacity = torch.sigmoid(logit_opacities)
    valid &= opacity >= MIN_ALPHA_THRESHOLD

    q_norm_sq = (quats * quats).sum(-1)
    valid &= q_norm_sq >= 1e-8
    rot = quat_to_rotmat(quats)  # [C, 3, 3]
    var = torch.exp(2.0 * log_scales)

    # --- normalized image-plane coords, clamped to a 15%-expanded frustum ---
    safe_depth = torch.where(depth.abs() > 1e-12, depth, 1e-12)
    x = p_cam[:, 0] / safe_depth
    y = p_cam[:, 1] / safe_depth
    clip_left = (-0.15 * width - cx) / fx
    clip_right = (1.15 * width - cx) / fx
    clip_top = (-0.15 * height - cy) / fy
    clip_bottom = (1.15 * height - cy) / fy
    tx = torch.minimum(torch.maximum(x, clip_left), clip_right)
    ty = torch.minimum(torch.maximum(y, clip_top), clip_bottom)

    # --- EWA: cov2d = (J W) cov3d (J W)^T, as sum_k var_k (a R)_k^2 ---
    j11 = fx / safe_depth
    j13 = -j11 * tx
    j22 = fy / safe_depth
    j23 = -j22 * ty
    w1, w2, w3 = rot_w2c[0], rot_w2c[1], rot_w2c[2]
    jw1 = j11[:, None] * w1[None, :] + j13[:, None] * w3[None, :]  # [C, 3]
    jw2 = j22[:, None] * w2[None, :] + j23[:, None] * w3[None, :]
    u1 = (jw1[:, :, None] * rot).sum(1)  # [C, 3]
    u2 = (jw2[:, :, None] * rot).sum(1)
    c_xx = (var * u1 * u1).sum(-1) + DILATION
    c_xy = (var * u1 * u2).sum(-1)
    c_yy = (var * u2 * u2).sum(-1) + DILATION

    det = c_xx * c_yy - c_xy * c_xy
    valid &= det >= 1e-8
    safe_det = torch.where(det.abs() > 1e-12, det, 1e-12)
    conic = torch.stack([c_yy / safe_det, -c_xy / safe_det, c_xx / safe_det], dim=-1)

    if antialiasing:
        # Mip-Splatting compensation (reference rasterizer.cpp:52,181
        # calc_compensations): opacity *= sqrt(det(cov2d) / det(cov2d + dilation))
        det_raw = (c_xx - DILATION) * (c_yy - DILATION) - c_xy * c_xy
        opacity = opacity * _safe_sqrt(torch.clamp(det_raw, min=0.0) / safe_det)
        valid &= opacity >= MIN_ALPHA_THRESHOLD

    mean2d = torch.stack([x * fx + cx, y * fy + cy], dim=-1)

    bbox, n_touched, valid, tile_mask = screen_bounds(
        mean2d, conic, c_xx, c_yy, opacity, valid, width=width, height=height,
        tile_size=tile_size, exact_tile_cap=exact_tile_cap, dilate_px=dilate_px)

    color = sh_to_color(sh0, shN, means, cam_position, active_sh_degree)

    return ProjectedSplats(
        depth=depth,
        mean2d=mean2d,
        conic=conic,
        opacity=opacity,
        color=color,
        bbox=bbox,
        n_touched=n_touched,
        valid=valid,
        tile_mask=tile_mask,
    )
