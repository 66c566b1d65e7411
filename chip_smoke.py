#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the CUDA
kernels, checks each against its plain PyTorch version, drives the headless
render path through the CLI at 1920x1080 on the 660k-gaussian SH-3 scene of
tools/bench_render.py and times it, then drives the MCMC train step at
bench.py's geometry (1M capacity, 600k live, 1296x840) through
bench_train.benchmark_train and times it.

    python3 chip_smoke.py

Exits non-zero, printing no result, without a CUDA device or without the
package beside it. The line before the last is the card's name and power
limit, and before it a JSON line with one entry per kernel. The last line
is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
P2_CHECK_TOL = 1e-4
ORACLE_TOL = 2.5e-3
P3_CHECK_REL = 1e-4  # per group, of the largest plain gradient
P4_CHECK_REL = 1e-5  # of the largest plain sum


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_scene(device, n: int, seed: int, size: int, fx: float):
    """A random scene with varied shapes, opacities and SH (for the
    kernel-against-plain checks)."""
    import numpy as np

    from lichtfeld_studio_tpu_torch.core.camera import look_at_camera
    from lichtfeld_studio_tpu_torch.core.splat_data import SplatData

    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    sd = SplatData.from_arrays(
        rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32),
        rng.normal(0, 1, (n, 1, 3)).astype(np.float32),
        (0.1 * rng.normal(size=(n, 15, 3))).astype(np.float32),
        rng.uniform(np.log(0.02), np.log(0.08), (n, 3)).astype(np.float32),
        quat / np.linalg.norm(quat, axis=1, keepdims=True),
        rng.normal(0, 1.5, (n, 1)).astype(np.float32),
        scene_scale=2.5, device=device,
    )
    cam = look_at_camera(np.array([0.0, -0.8, -8.0]), np.zeros(3), np.array([0.0, -1.0, 0.0]),
                         fx, fx, size, size)
    return sd, cam


def binned(sd, cam, device, tile_size=32, cap=None):
    from lichtfeld_studio_tpu_torch.ops.rasterize import _project
    from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment
    from lichtfeld_studio_tpu_torch.render.headless import _bucket_cap

    params = cam.device_params(device)
    proj = _project(sd, params, tile_size=tile_size)
    gw, gh = -(-cam.width // tile_size), -(-cam.height // tile_size)
    cap = cap or _bucket_cap(int(proj.n_touched.sum()))
    a = build_tile_assignment(proj, grid_w=gw, grid_h=gh, instance_cap=cap, need_grad=False)
    return proj, a, dict(grid_w=gw, grid_h=gh, tile_size=tile_size), cap


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        from lichtfeld_studio_tpu_torch.kernels import _build
        from lichtfeld_studio_tpu_torch.kernels import blend as kblend
        from lichtfeld_studio_tpu_torch.kernels import expand as kexpand
    except ImportError as e:
        fail(f"the lichtfeld_studio_tpu_torch package is not beside this script: {e}")
    import numpy as np

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # --- 1. environment ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave no answer"
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()} | {card}")

    # --- 2. build -----------------------------------------------------------
    lib_path, build_s = _build.build()
    _build.load_library()
    say(f"[build] {lib_path.relative_to(ROOT)} built in {build_s:.2f} s "
        f"(0.00 = already built) from {[p.name for p in _build.sources()]}")

    # --- 3. P1 against its plain version at the main path's size -------------
    from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
    from lichtfeld_studio_tpu_torch.ops.rasterize import _project, rasterize
    from lichtfeld_studio_tpu_torch.ops.tiles import pack_payload
    from lichtfeld_studio_tpu_torch.render.bench_scene import (
        HEIGHT as H, N_BENCH, WIDTH as W, bench_arrays, bench_cameras)

    arrays = bench_arrays()
    with torch.no_grad():
        splats = SplatData.from_arrays(*arrays.values(), scene_scale=3.0, device=dev)
        cams = bench_cameras()
        proj0 = _project(splats, cams[0].device_params(dev), tile_size=32)
        nt, payload = proj0.n_touched, pack_payload(proj0)
        total = int(nt.sum())
        cap_p1 = max(1 << 21, -(-total // 1024) * 1024)
        g_p, r_p, pl_p = kexpand.expand_instances_plain(nt, payload, cap_p1)
        g_k, r_k, pl_k = kexpand.expand_instances(nt, payload, cap_p1)
        torch.cuda.synchronize()
        slot = torch.arange(cap_p1, device=dev)
        valid = (slot < total) & (r_p < nt[g_p.long()])
        valid_k = (slot < total) & (r_k < nt[g_k.long()])
        p1_err = max(
            int((g_k - g_p)[valid].abs().max()), int((r_k - r_p)[valid].abs().max()),
            int((pl_k - pl_p)[:, valid].abs().max()),
        )
        in_bounds = bool((g_k >= 0).all() and (g_k < nt.shape[0]).all())
        if not (torch.equal(valid, valid_k) and p1_err == 0 and in_bounds):
            fail(f"P1 disagrees with its plain version (max |diff| {p1_err}, in-bounds {in_bounds})")
        p1_plain_ms = cuda_ms(lambda: kexpand.expand_instances_plain(nt, payload, cap_p1))
        p1_ms = cuda_ms(lambda: kexpand.expand_instances(nt, payload, cap_p1))
    say(f"[P1] expand_instances: {splats.capacity} gaussians, {total} instances, cap "
        f"{cap_p1}: equal on {int(valid.sum())} valid slots; kernel {p1_ms:.3f} ms, "
        f"plain {p1_plain_ms:.3f} ms | {card}")

    # --- 4. P2 against its plain version on a 256x256 scene ----------------------
    p2_err = 0.0
    with torch.no_grad():
        sd_c, cam_c = check_scene(dev, n=20_000, seed=1, size=256, fx=300.0)
        proj, a, kw, _ = binned(sd_c, cam_c, dev)
        for color in (proj.color, torch.cat([proj.color, proj.depth[:, None]], -1)):
            args = (a.tile_start, a.tile_count, a.gaussian_idx, proj.mean2d, proj.conic,
                    proj.opacity, color)
            img_p, al_p = kblend.blend_forward_plain(*args, **kw)
            img_k, al_k = kblend.blend_forward(*args, **kw)
            torch.cuda.synchronize()
            err = max(float((img_k - img_p).abs().max()), float((al_k - al_p).abs().max()))
            if not (torch.isfinite(img_k).all() and err <= P2_CHECK_TOL):
                fail(f"P2 disagrees with its plain version: max |diff| {err} > {P2_CHECK_TOL}")
            p2_err = max(p2_err, err)
        p2_small_ms = cuda_ms(lambda: kblend.blend_forward(*args, **kw))
        p2_small_plain_ms = cuda_ms(lambda: kblend.blend_forward_plain(*args, **kw), reps=2, warmup=0)
        # the whole binned path against the dense oracle on a small input
        sd_o, cam_o = check_scene(dev, n=2_000, seed=2, size=128, fx=150.0)
        params_o = cam_o.device_params(dev)
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
        out_c = rasterize(sd_o, params_o, bg, mode="cuda", inference=True, instance_cap=1 << 17)
        out_o = rasterize(sd_o, params_o, bg, mode="oracle")
        oracle_err = max(float((out_c.image - out_o.image).abs().max()),
                         float((out_c.alpha - out_o.alpha).abs().max()))
        if not oracle_err <= ORACLE_TOL:
            fail(f"cuda render disagrees with the oracle: max |diff| {oracle_err} > {ORACLE_TOL}")
    say(f"[P2] blend_forward 256x256, {sd_c.capacity} gaussians, {int(a.n_instances)} "
        f"instances (3 and 4 channels): max |kernel - plain| {p2_err:.3g} <= {P2_CHECK_TOL}; "
        f"kernel {p2_small_ms:.3f} ms, plain {p2_small_plain_ms:.3f} ms; 128x128 render vs "
        f"oracle max |diff| {oracle_err:.3g} <= {ORACLE_TOL} | {card}")

    # --- 5. main path: the CLI on the 660k SH-3 scene at 1080p --------------------
    from PIL import Image

    from lichtfeld_studio_tpu_torch import cli
    from lichtfeld_studio_tpu_torch.io.ply import write_ply
    from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment
    from lichtfeld_studio_tpu_torch.render.headless import (
        benchmark_fps, render_frame_u8, snug_cap)

    WORK.mkdir(parents=True, exist_ok=True)
    ply, png = WORK / "scene.ply", WORK / "view.png"
    png.unlink(missing_ok=True)
    write_ply(SplatData.from_arrays(*arrays.values(), scene_scale=3.0).to_point_cloud(), ply)
    kexpand.expand_instances.launches = 0
    kblend.blend_forward.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["-v", str(ply), "--render-output", str(png), "--render-size", str(W), str(H)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"expand_instances": kexpand.expand_instances.launches,
                "blend_forward": kblend.blend_forward.launches}
    if rc != 0:
        fail(f"the CLI returned {rc}")
    if min(launches.values()) < 1:
        fail(f"the main path did not run every kernel: {launches}")
    img = np.asarray(Image.open(png))
    if img.shape != (H, W, 3) or not img.std() > 1.0:
        fail(f"the rendered PNG is wrong: shape {img.shape}, std {img.std():.3f}")
    say(f"[main] cli -v scene.ply --render-output view.png --render-size {W} {H}: rc 0 in "
        f"{cli_s:.2f} s (PLY load + probe + render + PNG), PNG {img.shape} mean "
        f"{img.mean():.2f} std {img.std():.2f}, launches {launches}")

    # orbit: 8 bench cameras at the probe-snug cap, 20 frames, timed by the
    # package's own benchmark (raises on a cap overflow); 5 runs, since 20
    # frames take ~0.2 s and one host stall moves a single run
    with torch.no_grad():
        params = [c.device_params(dev) for c in cams]
        peak, cap = snug_cap(splats, cams)
        try:
            fps_runs = [benchmark_fps(splats, n_frames=20, instance_cap=cap, cameras=cams)
                        for _ in range(5)]
        except RuntimeError as e:
            fail(f"orbit: {e}")
        fps = sorted(fps_runs)[2]
        bg = torch.zeros(3, device=dev)
        out0 = rasterize(splats, params[0], bg, mode="cuda", instance_cap=cap, inference=True)
        if not bool(torch.isfinite(out0.image).all()) or float(out0.image.std()) < 0.01:
            fail("orbit frame is not a finite non-uniform image")

        # per-stage device time on view 0
        proj, a, kw, _ = binned(splats, cams[0], dev, cap=cap)
        stage = {
            "projection": cuda_ms(lambda: _project(splats, params[0], tile_size=32)),
            "binning": cuda_ms(lambda: build_tile_assignment(
                proj, grid_w=kw["grid_w"], grid_h=kw["grid_h"], instance_cap=cap,
                need_grad=False)),
        }
        args = (a.tile_start, a.tile_count, a.gaussian_idx, proj.mean2d, proj.conic,
                proj.opacity, proj.color)
        stage["blend (P2)"] = cuda_ms(lambda: kblend.blend_forward(*args, **kw))
        img4, alpha = kblend.blend_forward(*args, **kw)
        stage["composite+u8"] = cuda_ms(lambda: torch.clamp(
            (img4[:H, :W] + (1.0 - alpha[:H, :W, None]) * bg) * 255.0 + 0.5, 0.0, 255.0
        ).to(torch.uint8))
        stage["frame"] = cuda_ms(lambda: render_frame_u8(splats, params[0], bg, "cuda", cap), reps=5)
        p2_ms = stage["blend (P2)"]
        # P2 against its plain version at the main path's own shape
        t0 = time.perf_counter()
        img_p, al_p = kblend.blend_forward_plain(*args, **kw)
        torch.cuda.synchronize()
        p2_plain_ms = 1e3 * (time.perf_counter() - t0)
        big_err = max(float((img4 - img_p).abs().max()), float((alpha - al_p).abs().max()))
        del img_p, al_p
        if not (torch.isfinite(img4).all() and big_err <= P2_CHECK_TOL):
            fail(f"P2 disagrees with its plain version at {W}x{H}: max |diff| {big_err} "
                 f"> {P2_CHECK_TOL}")
    say(f"[main] orbit 8 views {W}x{H}, {N_BENCH} gaussians SH3: peak {peak} instances, cap "
        f"{cap}, median {fps:.2f} FPS of 5 runs of 20 frames "
        f"({', '.join(f'{f:.2f}' for f in fps_runs)}; benchmark_fps: device path, u8 on "
        f"device) | {card}")
    say("[main] view 0 stage ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + f"; P2 plain version {p2_plain_ms:.1f} ms (1 run), max |kernel - plain| at {W}x{H} "
        f"{big_err:.3g} <= {P2_CHECK_TOL} | {card}")

    # --- 6. the training kernels against their plain versions ---------------------
    from lichtfeld_studio_tpu_torch import bench_train
    from lichtfeld_studio_tpu_torch.core.camera import CameraParams
    from lichtfeld_studio_tpu_torch.kernels import segment_reduce as kseg

    p2t_err, p3_rel, p4_rel = 0.0, 0.0, 0.0
    with torch.no_grad():
        checks = [("256x256", *check_scene(dev, n=20_000, seed=1, size=256, fx=300.0), ts, 1 << 20)
                  for ts in (16, 32)]
        sd_b, cam_b, _, _, cfg_b, _ = bench_train.bench_setup(dev)
        checks.append((f"{cam_b.width}x{cam_b.height}", sd_b, cam_b, 32, cfg_b.instance_cap))
        for label, sd, cam, ts, cap in checks:
            params = cam if isinstance(cam, CameraParams) else cam.device_params(dev)
            proj = _project(sd, params, tile_size=ts)
            gw, gh = -(-params.width // ts), -(-params.height // ts)
            a = build_tile_assignment(proj, grid_w=gw, grid_h=gh, instance_cap=cap)
            kw = dict(grid_w=gw, grid_h=gh, tile_size=ts)
            args = (a.tile_start, a.tile_count, a.gaussian_idx, proj.mean2d, proj.conic,
                    proj.opacity, proj.color)
            t0 = time.perf_counter()
            plain = kblend.blend_forward_plain(*args, **kw, train=True)
            torch.cuda.synchronize()
            p2t_plain_ms = 1e3 * (time.perf_counter() - t0)
            kern = kblend.blend_forward(*args, **kw, train=True)
            torch.cuda.synchronize()
            err = max(float((k - q).abs().max()) for k, q in zip(kern[:3], plain[:3]))
            if not (torch.isfinite(kern[0]).all() and err <= P2_CHECK_TOL
                    and torch.equal(kern[3], plain[3])):
                fail(f"P2-train disagrees with its plain version at {label}, {ts}-px tiles: max "
                     f"|diff| {err}, last index equal {torch.equal(kern[3], plain[3])}")
            p2t_err = max(p2t_err, err)
            p2t_ms = cuda_ms(lambda: kblend.blend_forward(*args, **kw, train=True))
            say(f"[P2-train] {label} {ts}-px tiles, {int(a.n_instances)} instances: max |kernel - "
                f"plain| {err:.3g} <= {P2_CHECK_TOL}, last counted index equal; kernel "
                f"{p2t_ms:.3f} ms, plain {p2t_plain_ms:.1f} ms (1 run) | {card}")

            # P3 -> P4 against autograd through the plain blend -> plain P4
            _, _, t_final, last = kern
            gen = torch.Generator(device=dev).manual_seed(ts)
            d_image = torch.randn(t_final.shape + (3,), generator=gen, device=dev)
            d_alpha = torch.randn(t_final.shape, generator=gen, device=dev)
            bwd = (a.tile_start, a.tile_count, a.gaussian_idx, a.slot_layout, *args[3:],
                   t_final, last, d_image, d_alpha)
            t0 = time.perf_counter()
            g_p = kseg.segment_reduce_plain(kblend.blend_backward_plain(*bwd, **kw), a.segment_off)
            torch.cuda.synchronize()
            p3_plain_ms = 1e3 * (time.perf_counter() - t0)
            rows = kblend.blend_backward(*bwd, **kw)
            g_k = kseg.segment_reduce(rows, a.segment_off)
            torch.cuda.synchronize()
            rel = max(float((g_k[:, c] - g_p[:, c]).abs().max() / g_p[:, c].abs().max())
                      for c in (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 9)))
            if not (torch.isfinite(g_k).all() and rel <= P3_CHECK_REL):
                fail(f"P3 -> P4 disagrees with the plain backward at {label}, {ts}-px tiles: "
                     f"{rel} > {P3_CHECK_REL} of the largest gradient")
            p3_rel = max(p3_rel, rel)
            p3_ms = cuda_ms(lambda: kblend.blend_backward(*bwd, **kw))
            say(f"[P3] {label} {ts}-px tiles: P3 -> P4 against the plain backward (autograd "
                f"through the dense blend, float64 segment sums), per group max |diff| "
                f"{rel:.3g} of the largest gradient <= {P3_CHECK_REL}; P3 kernel {p3_ms:.3f} ms, "
                f"plain backward + P4 {p3_plain_ms:.1f} ms (1 run) | {card}")
        # P4 alone at the train path's size, on P3's rows of the bench scene
        n_seg = a.segment_off.shape[0] - 1
        s4_p = kseg.segment_reduce_plain(rows, a.segment_off)
        s4_k = kseg.segment_reduce(rows, a.segment_off)
        torch.cuda.synchronize()
        p4_rel = float((s4_k - s4_p).abs().max() / s4_p.abs().max())
        if not p4_rel <= P4_CHECK_REL:
            fail(f"P4 disagrees with its plain version: {p4_rel} > {P4_CHECK_REL}")
        p4_ms = cuda_ms(lambda: kseg.segment_reduce(rows, a.segment_off))
        p4_plain_ms = cuda_ms(lambda: kseg.segment_reduce_plain(rows, a.segment_off))
        p2t_big_ms, p2t_big_plain_ms, p3_big_ms, p3_big_plain_ms = (
            p2t_ms, p2t_plain_ms, p3_ms, p3_plain_ms)
        say(f"[P4] {n_seg} gaussians, {int(a.n_instances)} instances, cap {rows.shape[0]}, "
            f"{rows.shape[1]} columns: max |kernel - plain| {p4_rel:.3g} of the largest sum <= "
            f"{P4_CHECK_REL}; kernel {p4_ms:.3f} ms, plain {p4_plain_ms:.3f} ms | {card}")
        del sd_b, checks, proj, a, rows, plain, kern, g_p, g_k, s4_p, s4_k, bwd

    # --- 7. main path: the MCMC train step at bench.py's geometry ------------------
    # first, the step's loss and gradients against the dense oracle's on a
    # small input (the repo's own reference for the binned path)
    from lichtfeld_studio_tpu_torch.train.state import (
        TrainConfig, compute_grads, init_train_state, make_lrs)

    sd_s, cam_s = check_scene(dev, n=2_000, seed=2, size=128, fx=150.0)
    gt_s = torch.rand((128, 128, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    state_s = init_train_state(sd_s, make_lrs(1.6e-4, 2.5e-3, 5e-3, 1e-3, 0.05, 2.5))
    step = {mode: compute_grads(state_s, cam_s.device_params(dev), gt_s, torch.zeros(3, device=dev),
                                TrainConfig(raster_mode=mode, tile_size=16, instance_cap=1 << 17))
            for mode in ("oracle", "cuda")}
    loss_rel = abs(float(step["cuda"][0]) / float(step["oracle"][0]) - 1.0)
    grad_rel = max(float((step["cuda"][2][k] - g).abs().max() / g.abs().max())
                   for k, g in step["oracle"][2].items())
    if not (loss_rel <= 1e-5 and grad_rel <= P3_CHECK_REL):
        fail(f"train step vs the dense oracle at 128x128: loss rel {loss_rel}, grads {grad_rel}")
    say(f"[train] compute_grads at 128x128, 2000 gaussians, 16-px tiles, against the dense "
        f"oracle: loss rel {loss_rel:.3g} <= 1e-05, per group max |diff| {grad_rel:.3g} of "
        f"the largest gradient <= {P3_CHECK_REL} | {card}")
    del sd_s, state_s, step

    counters = {"expand_instances": kexpand.expand_instances,
                "blend_forward": kblend.blend_forward,
                "blend_backward": kblend.blend_backward,
                "segment_reduce": kseg.segment_reduce}
    for fn in counters.values():
        fn.launches = 0
    r = bench_train.benchmark_train(dev, warmup=1, dispatches=3, refine_warm=1, refine_timed=2,
                                    log=lambda msg: say(f"[train] {msg}"))
    torch.cuda.synchronize()
    train_launches = {k: fn.launches for k, fn in counters.items()}
    state = r.pop("state")
    if not (r["all_losses_finite"] and r["max_n_nonfinite"] == 0
            and r["max_n_instances"] <= r["instance_cap"]):
        fail(f"train: unhealthy steps {r}")
    if min(train_launches.values()) < 1:
        fail(f"the train path did not run every kernel: {train_launches}")
    if not r["n_active_after_refine"] > r["n_active_before_refine"]:
        fail(f"train: refine steps did not grow the model: {r}")
    cam_t, gt_t, bg_t, cfg_t = r.pop("inputs")
    say(f"[train] {r['steps']} steps on {r['device']}: plain {r['plain_ms']:.2f} ms/step, refine "
        f"{r['refine_ms']:.2f} ms/step, amortised {r['amortized_ms']:.2f} ms/step -> "
        f"{r['it_s']:.2f} it/s (vs_baseline {r['it_s'] / bench_train.BASELINE_ITS:.4f}); loss "
        f"{r['loss_first']:.4f} -> {r['loss_last']:.4f}; max instances {r['max_n_instances']} <= "
        f"cap {r['instance_cap']}; n_nonfinite 0; n_active {r['n_active_before_refine']} -> "
        f"{r['n_active_after_refine']} over {r['refine_steps']} refine steps; launches "
        f"{train_launches} | {card}")
    # one plain step under the profiler: device events per step, busy share,
    # and device ms per stage, read from the step's own profiler ranges
    from lichtfeld_studio_tpu_torch.profiling import device_summary, stage_device_ms
    from lichtfeld_studio_tpu_torch.train.state import StepFlags, train_step

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = train_step(state, cam_t, gt_t, bg_t, cfg_t, StepFlags())
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    d = device_summary(prof, top=8)
    if d is None:
        say(f"[train] one plain step under the profiler: the trace holds no device events "
            f"(launches and stage ms per step not measured) | {card}")
    else:
        say(f"[train] one plain step under the profiler: {d['events']} device events "
            f"({d['copies']} copies/fills), device time summed {d['summed_us'] / 1e3:.3f} ms, "
            f"busy (union) {d['busy_us'] / 1e3:.3f} ms over a span of {d['span_us'] / 1e3:.3f} "
            f"ms; wall under the profiler {traced_ms:.2f} ms | {card}")
        for name, count, us in d["top"]:
            say(f"[train]   {us / 1e3:7.3f} ms {count:4d}x  {name[:100]}")
        stage = stage_device_ms(prof)
        say("[train] stage device ms of that step: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(stage.items(), key=lambda kv: -kv[1]))
            + f"; not linked to a host op {d['summed_us'] / 1e3 - sum(stage.values()):.3f} "
            f"| {card}")

    kernels = [
        {"name": "expand_instances", "route": "cuda",
         "source": "lichtfeld_studio_tpu_torch/csrc/expand.cu",
         "replaces": "lichtfeld_studio_tpu/kernels/expand_pallas.py:67",
         "launches": launches["expand_instances"] + train_launches["expand_instances"],
         "launches_by_path": {"render": launches["expand_instances"],
                              "train": train_launches["expand_instances"]},
         "max_abs_err": float(p1_err), "ms": p1_ms, "plain_ms": p1_plain_ms},
        {"name": "blend_forward", "route": "cuda",
         "source": "lichtfeld_studio_tpu_torch/csrc/blend_forward.cu",
         "replaces": "lichtfeld_studio_tpu/kernels/blend_pallas.py:293",
         "launches": launches["blend_forward"] + train_launches["blend_forward"],
         "launches_by_path": {"render": launches["blend_forward"],
                              "train": train_launches["blend_forward"]},
         "max_abs_err": max(p2_err, big_err, p2t_err), "max_abs_err_inference": max(p2_err, big_err),
         "max_abs_err_train": p2t_err, "ms": p2_ms, "plain_ms": p2_plain_ms,
         "ms_train": p2t_big_ms, "plain_ms_train": p2t_big_plain_ms},
        {"name": "blend_backward", "route": "cuda",
         "source": "lichtfeld_studio_tpu_torch/csrc/blend_backward.cu",
         "replaces": "lichtfeld_studio_tpu/kernels/blend_pallas.py:514",
         "launches": train_launches["blend_backward"], "max_abs_err": p3_rel,
         "max_err_is": "relative to the largest plain gradient of each group",
         "ms": p3_big_ms, "plain_ms": p3_big_plain_ms},
        {"name": "segment_reduce", "route": "cuda",
         "source": "lichtfeld_studio_tpu_torch/csrc/segment_reduce.cu",
         "replaces": "lichtfeld_studio_tpu/kernels/segment_reduce.py:72",
         "launches": train_launches["segment_reduce"], "max_abs_err": p4_rel,
         "max_err_is": "relative to the largest plain sum",
         "ms": p4_ms, "plain_ms": p4_plain_ms},
    ]
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
