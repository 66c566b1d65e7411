"""Viewer traffic: a closed loop of frames through the headless renderer's
frame path, `render/headless.py::render_frame_u8`, over a seeded orbit.

Set-up (counted in setup_s): the configuration's warm-start PLY from the
seed, read through the program's PLY loader (`splats_from_ply`); the
orbit's cameras; the instance cap the renderer's own probe gives for them
(`snug_cap`); one frame of each camera. The window: frame after frame,
camera after camera, each issued when the previous frame's u8 image is on
the host. A traced run times `untraced_frames` frames by the host's clock,
then traces `busy_frames` frames of the device alone and `trace_frames`
with the host's ops, instead of timing `seconds`.

Correctness (after the window, the model freed): a seeded sample of the
window's frames is rendered again by port_bench/reference/raster.py (EWA,
SH, binning, the blend that stops a pixel below 1/512 transmittance) from
the same PLY and the same cameras, quantised as the renderer quantises,
and compared in u8 levels.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from port_bench.harness import Check, Result, memory_peak, sync
from port_bench.reference import raster
from port_bench.scene import garden
from port_bench.work import counts


def _intrinsics(tr: dict) -> dict:
    w, h = tr["width"], tr["height"]
    return {"fx": tr["fx"], "fy": tr["fx"], "cx": w / 2.0, "cy": h / 2.0, "width": w, "height": h}


def _ref_views(cams: list[dict], intr: dict, device) -> list[raster.View]:
    return [raster.View(torch.tensor(c["R"], dtype=torch.float32, device=device),
                        torch.tensor(c["T"], dtype=torch.float32, device=device), intr["fx"],
                        intr["fy"], intr["cx"], intr["cy"], intr["width"], intr["height"])
            for c in cams]


def reference_frame(params: dict, view: raster.View, tile_size: int, *, tf32: bool = False):
    """The reference's u8 frame ([H, W, 3]) of `view` (black background)."""
    with torch.no_grad():
        pr = raster.project(params, view, tile_size)
        b = raster.bin_tiles(pr, view.width, view.height, tile_size, frame_order=True)
        img, _ = raster.render(pr, b, view.width, view.height, stop=raster.INFERENCE_STOP,
                               tf32=tf32)
    return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def compare(frames: list, params: dict, views: list, ctx) -> list[Check]:
    """Largest u8 difference over the sampled frames, and the share of u8
    values that differ at all."""
    worst, differ, n, refs = 0, 0, 0, {}
    ts = ctx.traffic["params"]["tile_size"]
    for cam, img in frames:
        if cam not in refs:
            refs[cam] = reference_frame(params, views[cam], ts).cpu().numpy().astype(np.int16)
        ref = refs[cam]
        d = np.abs(img.astype(np.int16) - ref)
        worst = max(worst, int(d.max()))
        differ += int((d > 0).sum())
        n += d.size
    lim = ctx.limits
    return [Check("frame_max_diff", float(worst), lim["frame_max_diff"]),
            Check("frame_diff_share", differ / n, lim["frame_diff_share"])]


def run(ctx) -> Result:
    from lichtfeld_studio_tpu_torch.core.camera import Camera
    from lichtfeld_studio_tpu_torch.render.headless import (
        render_frame_u8,
        snug_cap,
        splats_from_ply,
    )

    tr = ctx.traffic["params"]
    dev = ctx.device
    data = garden.build(ctx.cache / "data", ctx.config, ctx.seed, dev, views=False)
    ctx.mark("model made")
    splats = splats_from_ply(data / "init.ply", device=dev)
    intr = _intrinsics(tr)
    cams = garden.orbit_cameras(tr, ctx.seed)
    cameras = [Camera(R=c["R"].astype(np.float32), T=c["T"].astype(np.float32), fx=intr["fx"],
                      fy=intr["fy"], cx=intr["cx"], cy=intr["cy"], width=intr["width"],
                      height=intr["height"], uid=k) for k, c in enumerate(cams)]
    _, cap = snug_cap(splats, cameras)
    params = [c.device_params(dev) for c in cameras]
    bg = torch.zeros(3, device=dev)
    for p in params:  # every shape the window uses, once
        render_frame_u8(splats, p, bg, "cuda", cap)[0].cpu()
    sync(dev)

    rng = np.random.default_rng(garden.seed_of(ctx.seed, 7))
    keep, n_inst = [], []  # a seeded reservoir of the window's frames; instances a frame

    def frames(count: int | None, seconds: float | None) -> tuple[int, float]:
        """Frames until `count` frames or `seconds` have passed: (frames, s)."""
        t0 = time.perf_counter()
        k = 0
        while True:
            cam = len(n_inst) % len(params)
            img, n = render_frame_u8(splats, params[cam], bg, "cuda", cap)
            host = img.cpu().numpy()
            now = time.perf_counter()
            n_inst.append(n)
            k += 1
            if len(keep) < tr["sample_frames"]:
                keep.append((cam, host))
            else:
                j = int(rng.integers(0, len(n_inst)))
                if j < tr["sample_frames"]:
                    keep[j] = (cam, host)
            if (k >= count) if count else (now - t0 >= seconds):
                sync(dev)
                return k, time.perf_counter() - t0

    ctx.start_window()
    if ctx.trace:
        from port_bench.trace import device_trace, summarize

        n_plain, plain_s = frames(tr["untraced_frames"], None)
        with device_trace(host=False) as busy_prof:
            t0 = time.perf_counter()
            n_busy, _ = frames(tr["busy_frames"], None)
            busy_s = time.perf_counter() - t0
        with device_trace(host=True) as stage_prof:
            n_stage, _ = frames(tr["trace_frames"], None)
        k, secs = n_plain + n_busy + n_stage, plain_s
    else:
        k, secs = frames(None, ctx.seconds)
    ctx.mark("window closed")
    peak = memory_peak(dev)
    over = torch.stack(n_inst) > cap
    failed = int(over.sum())
    trace = readings = None
    if ctx.trace:
        trace = summarize(busy_prof, busy_s, n_busy, stage_prof, n_stage, plain_s, n_plain)
    del splats, params, n_inst
    gc.collect()
    torch.cuda.empty_cache()
    model = garden.read_ply(data / "init.ply", dev)
    views = _ref_views(cams, intr, dev)
    if ctx.trace:
        readings = {"trace": trace, "work": counts.frame_work(model, views, tr["tile_size"])}
    checks = compare(keep, model, views, ctx)
    ctx.mark("reference compared")
    return Result(metrics={"frames_s": k / secs},
                  attempted=k, failed=failed, memory_peak_bytes=peak, checks=checks,
                  readings=readings or {}, trace=trace)


def readings(ctx, side: str) -> list[Check]:
    """The check's numbers for `side` (port_bench/readings.py): the
    program's sampled frames of a short window, the reference with TF32
    on in its place ("control"), or the reference with one pixel of each
    frame altered ("pixel")."""
    if side == "program":
        return run(ctx).checks
    tr = ctx.traffic["params"]
    data = garden.build(ctx.cache / "data", ctx.config, ctx.seed, ctx.device, views=False)
    model = garden.read_ply(data / "init.ply", ctx.device)
    intr = _intrinsics(tr)
    views = _ref_views(garden.orbit_cameras(tr, ctx.seed), intr, ctx.device)
    frames = []
    for cam, view in enumerate(views):
        img = reference_frame(model, view, tr["tile_size"], tf32=side == "control").cpu().numpy()
        if side == "pixel":
            img[intr["height"] // 2, intr["width"] // 2, 0] ^= 0x40
        frames.append((cam, img))
    ctx.start_window()
    return compare(frames, model, views, ctx)
