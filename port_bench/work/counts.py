"""The yardstick's work counts: the operations and bytes that a step or a
frame needs, from its inputs, and the least time the card could take.

Bytes: each input byte read once, each output byte written once. The
blends' operations: the (pixel, instance) pairs that these inputs need, as
the reference's own walk finds them (port_bench/reference/raster.py): the
forward tests every instance up to the pixel's end (the term that takes
its transmittance below 1e-4, or 1/512 for a frame, or the tile's last
instance) and composites the counted ones; the backward visits each
pixel's instances up to its last counted one, within the tail trim's kept
range, and differentiates the counted ones. No count comes from the
program's counters or from a kernel's skip scheme, so a kernel that walks
less reads a higher share, never a different count.

Operation counts are float32 operations (an FMA counts two).
"""

from __future__ import annotations

import torch

from port_bench.reference import raster, world
from port_bench.scene import garden

# the card's peaks (NVIDIA H100 SXM data sheet, dense, at the full 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# per (pixel, instance) pair
OPS_TEST = 13  # offset (2), power (7), exp and opacity (2), two compares
OPS_FORWARD = 10  # weight, three colour FMAs, transmittance, done test
OPS_BACKWARD = 50  # d alpha from colour and the rest, d mean2d, d conic, d opacity, d colour
# per (pixel, instance) pair of the world-space blend (3DGUT)
OPS_WORLD_TEST = 40  # M d, the cross product with M (o - mean), two squared norms, exp
OPS_WORLD_BACKWARD = 80
# per gaussian
OPS_PROJECT = 800  # EWA projection and SH degree 3, forward and backward
OPS_PROJECT_UT = 1500  # seven sigma points through the camera model, SH, forward and backward
# per pixel of the padded grid: the fisheye ray (ten Newton steps) and its rotation
OPS_RAY = 200
OPS_ADAM = 12  # a parameter
OPS_NOISE = 40
PARAMS = 59  # floats a gaussian at SH degree 3
# per pixel
OPS_LOSS = 2000  # L1 and SSIM (five 11x11 separable blurs, 3 channels), forward and backward
FEATURE_BYTES = 36  # mean2d, conic, opacity, colour of one gaussian


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


@torch.no_grad()
def walk(pr: raster.Projected, b: raster.Binning, *, stop: float = 0.0,
         trim_eps: float = 0.0, rays=None, feat=None) -> dict:
    """Pairs of the forward walk and its counted pairs, and the backward's
    pairs and counted pairs (within the kept range where trim_eps > 0).
    With `rays` and `feat` the alphas are the world-space blend's."""
    out = dict(walked=0, counted=0, back=0, back_counted=0)
    n_pix = b.tile_size ** 2
    end_at = max(stop, raster.T_DONE)
    groups = world._groups(b) if rays is not None else raster._groups(b.tile_count, n_pix)
    for tiles, k in groups:
        g, in_range, _, px, py = raster._gather(b, tiles, k)
        if rays is not None:
            a = world._alphas(feat[g], in_range, rays[0], rays[1][tiles])
        else:
            a = raster._alphas(pr.mean2d[g], pr.conic[g], pr.opacity[g], in_range, px, py)
        cum = torch.cumprod(1.0 - a, dim=1)
        before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        counted = (cum >= raster.T_DONE) & (a > 0)
        if stop > 0:
            counted &= before >= stop
        kk = torch.arange(k, device=a.device)[None, :, None]
        ends = cum < end_at
        cnt = b.tile_count[tiles][:, None]
        n_walk = torch.where(ends.any(1), ends.float().argmax(1) + 1, cnt)
        out["walked"] += int(torch.minimum(n_walk, cnt).sum())
        out["counted"] += int(counted.sum())
        kept = (raster._trim_keep(cum, b.tile_start[tiles], b.tile_count[tiles], trim_eps)
                if trim_eps > 0 else b.tile_count[tiles])
        last = torch.where(counted, kk, -1).amax(1)
        out["back"] += int(torch.minimum(last + 1, kept[:, None]).sum())
        out["back_counted"] += int((counted & (kk < kept[:, None, None])).sum())
    return out


def _view(intr: dict, v: dict, device) -> raster.View:
    return raster.View(torch.tensor(v["R"], device=device), torch.tensor(v["T"], device=device),
                       intr["fx"], intr["fy"], intr["cx"], intr["cy"], intr["width"],
                       intr["height"], intr["model"], tuple(intr["radial"]))


def train_work(params: dict, config: dict, data, uids: list[int]) -> dict:
    """Mean work of one train step over the views `uids` on `params`: the
    whole step's operations and bytes, and the blend backward's (P3, or P6
    for the world-space blend of --gut-exact)."""
    device = params["means"].device
    intr, views = garden.read_colmap_views(data)
    ts = config["train"]["tile_size"]
    exact = config["train"]["gut_exact"]
    n = params["means"].shape[0]
    pixels = intr["width"] * intr["height"]
    bwd = "p6" if exact else "p3"
    acc = {"step_flops": 0.0, "step_bytes": 0.0, f"{bwd}_flops": 0.0, f"{bwd}_bytes": 0.0}
    for uid in uids:
        view = _view(intr, views[uid], device)
        with torch.no_grad():
            pr = (world.project_ut if exact else raster.project)(params, view, ts)
            b = raster.bin_tiles(pr, view.width, view.height, ts)
            n_bin = int(pr.valid.sum())
            t_count = b.grid_w * b.grid_h
            padded = t_count * ts * ts
            if exact:
                w = walk(pr, b, rays=world.world_rays(view, ts), feat=world.features(params, pr))
                test, back = OPS_WORLD_TEST, OPS_WORLD_BACKWARD
                per_gaussian = OPS_PROJECT_UT
                acc["p6_bytes"] += 104 * b.n_instances + 96 * n_bin + 12 * t_count + 36 * padded
                extra = padded * OPS_RAY
            else:
                w = walk(pr, b, trim_eps=raster.TRIM_EPS)
                test, back = OPS_TEST, OPS_BACKWARD
                per_gaussian = OPS_PROJECT
                acc["p3_bytes"] += (44 * b.n_instances + FEATURE_BYTES * n_bin + 12 * t_count
                                    + 24 * padded)
                extra = 0
        blend_f = w["walked"] * test + w["counted"] * OPS_FORWARD
        bwd_f = w["back"] * test + w["back_counted"] * back
        acc[f"{bwd}_flops"] += bwd_f
        acc["step_flops"] += (blend_f + bwd_f + extra
                              + n * (per_gaussian + OPS_NOISE + OPS_ADAM * PARAMS)
                              + pixels * OPS_LOSS)
        # parameters, Adam's two moments: read; parameters, moments: written;
        # the target image read
        acc["step_bytes"] += 6 * 4 * PARAMS * n + 12 * pixels
    return {k: v / len(uids) for k, v in acc.items()}


def frame_work(params: dict, views: list[raster.View], tile_size: int) -> dict:
    """Mean work of one frame's forward blend (P2) over `views`."""
    acc = dict(p2_flops=0.0, p2_bytes=0.0)
    for view in views:
        with torch.no_grad():
            pr = raster.project(params, view, tile_size)
            b = raster.bin_tiles(pr, view.width, view.height, tile_size, frame_order=True)
        w = walk(pr, b, stop=raster.INFERENCE_STOP)
        t_count = b.grid_w * b.grid_h
        acc["p2_flops"] += w["walked"] * OPS_TEST + w["counted"] * OPS_FORWARD
        acc["p2_bytes"] += (4 * b.n_instances + FEATURE_BYTES * int(pr.valid.sum())
                            + 8 * t_count + 16 * t_count * tile_size ** 2)
    return {k: v / len(views) for k, v in acc.items()}
