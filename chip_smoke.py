#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the CUDA
kernels, checks each against its plain PyTorch version, drives the headless
render path through the CLI at 1920x1080 on the 660k-gaussian SH-3 scene of
tools/bench_render.py and times it, drives the MCMC train step at
bench.py's geometry (1M capacity, 600k live, 1296x840) through
bench_train.benchmark_train and times it, then drives the --gut-exact
train step and forward frame through an OpenCV-fisheye camera at the same
geometry (tools/bench_world_blend.py's) through bench_gut.benchmark_gut.
Then the microbenchmark kernels T1a, T1b, T2 and T3 through their tools'
entry points; the trainer end to end through the CLI's main(argv) at
bench.py's width (an 8-view 1296x840 dataset written here from
bench_train's scene, 600k random points, 40 iterations with eval, PLY and
state snapshot, then a resume); and tools/selfcheck_train.py's protocol
(24 views 512x384, MCMC 2000 iterations with its SSIM and kernel-parity
gates, then a shorter ADC run across one opacity reset).
Each kernel's line carries its least time on the card (bound_ms: the larger
of its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s, the
H100 SXM data sheet, counted from this run's inputs).

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
P5_CHECK_TOL = 1e-4
P6_CHECK_REL = 1e-4  # per group, of the largest plain gradient
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16X2_FLOPS = 133.8e12  # H100 SXM, packed bf16 outside the tensor cores (H100 white paper)
SELFCHECK_ITERS = 2000  # tools/selfcheck_train.py's fast gate (MCMC)
SELFCHECK_ADC_ITERS = 3000  # ADC: an opacity reset at 1500, refines at 400..2600
# float32 operations per (pixel, instance) pair, counted from the kernels'
# code (their headers list them): WALK_OPS to evaluate and test each pair a
# kernel walks (P2 and P3 sigma, exp, scale, clamp and tests; P5 and P6 y
# and z, |y|^2, |z|^2, the division and the test), COUNTED_OPS more for
# each pair that passes the test and counts (the compositing, or the
# backward terms). P5 and P6 at a global shutter, as the main path runs them.
WALK_OPS = {"P2": 16, "P3": 16, "P5": 44, "P6": 44}
COUNTED_OPS = {"P2": 13, "P3": 51, "P5": 18, "P6": 79}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def bound(bytes_moved: float, flops: float, rate: float = F32_FLOPS) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for a kernel's bytes and its
    operations at `rate` (float32 unless said)."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def backward_pairs(last) -> int:
    """(pixel, instance) pairs a backward walk evaluates: each pixel's
    instances up to its last counted one."""
    return int((last.long() + 1).sum())


def blend_ops(kernel: str, walked: int, counted: int) -> int:
    return WALK_OPS[kernel] * walked + COUNTED_OPS[kernel] * counted


def forward_pairs(groups, threshold: float = 0.0) -> tuple[int, int]:
    """(pairs a forward walk evaluates, pairs that count) of this run's
    data, from a plain version's per-group alphas: `groups` yields (alphas
    [t, K, P], in_range [t, K], tile_count [t]). A pixel walks its tile's
    instances up to the one that ends it (all of them if none does), to
    within one pair per pixel."""
    import torch

    from lichtfeld_studio_tpu_torch.ops.blend_ref import blend_weights

    walked = counted_n = 0
    for alphas, in_range, count in groups:
        _, counted = blend_weights(alphas, threshold)
        counted &= in_range[..., None]  # a prefix of each pixel's range
        n = counted.sum(dim=1)
        walked += int(torch.minimum(n + 1, count[:, None].long()).sum())
        counted_n += int((counted & (alphas > 0.0)).sum())
    return walked, counted_n


def blend_groups(args, kw):
    """The 2D blend's per-group alphas (P2's plain version's pieces)."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import blend as kblend

    tile_start, tile_count, gidx, mean2d, conic, opacity, _ = args
    ts = kw["tile_size"]
    for t0, t1, k_max in kblend._plain_groups(tile_count, ts * ts):
        _, in_range, g, _, px, py = kblend._gather_group(t0, t1, k_max, tile_start, tile_count,
                                                         gidx, kw["grid_w"], ts)
        alphas = kblend.compute_alphas(mean2d[g], conic[g], torch.where(in_range, opacity[g], 0.0),
                                       px, py)
        yield alphas, in_range, tile_count[t0:t1]


def world_groups(stream, rays_d, tau, a, kw):
    """The world blend's per-group alphas (P5's plain version's pieces)."""
    from lichtfeld_studio_tpu_torch.kernels import blend as kblend
    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb

    ts = kw["tile_size"]
    lay = kwb._Layout(stream.shape[1] == kwb.STREAM_ROWS_RS)
    d_t, tau_t = kwb._tile_rays(rays_d, tau, kw["grid_w"], kw["grid_h"], ts)
    for t0, t1, k_max in kblend._plain_groups(a.tile_count, ts * ts):
        _, in_range, g, _, _, _ = kblend._gather_group(t0, t1, k_max, a.tile_start, a.tile_count,
                                                       a.gaussian_idx, kw["grid_w"], ts)
        alphas = kwb._stream_alphas(stream[g], d_t[t0:t1],
                                    tau_t[t0:t1] if tau_t is not None else None, in_range, lay)
        yield alphas, in_range, a.tile_count[t0:t1]


def stream_column_groups(n_rows: int, with_depth: bool) -> list[slice]:
    """The column groups of a world-blend stream row and of its gradient
    (kernels/world_blend.py): C' (C0' and C1' with a rolling shutter), M,
    -log2 op, the colour, and the depth channel where it is rendered."""
    geo = [slice(0, 9), slice(9, 18)] + ([slice(18, 27)] if n_rows == 32 else [])
    c = 28 if n_rows == 32 else 19
    return geo + [slice(c - 1, c), slice(c, c + 3)] + ([slice(c + 3, c + 4)] if with_depth else [])


def capture_world_inputs(splats, params, *, tile_size, instance_cap, with_depth=False,
                         inference=False):
    """The arguments that rasterize(projection="ut", gut_exact=True) hands
    its world blend, captured in place of the blend, so that a check reads
    what the path reads: (stream, rays_d, tau, assignment, kw) for the
    training path (world_blend_fused), (stream, rays_d, tau, tile_start,
    tile_count, gaussian_idx, kw) for the forward frame's
    (world_blend_forward); kw holds n_channels and the tile grid."""
    import torch

    from lichtfeld_studio_tpu_torch.ops import rasterize as rmod

    name = "world_blend_forward" if inference else "world_blend_fused"
    seen = []

    def capture(*args, **kw):
        seen.append((*args, kw))
        hp, wp = kw["grid_h"] * kw["tile_size"], kw["grid_w"] * kw["tile_size"]
        z = torch.zeros((hp, wp), device=args[0].device)
        out = (torch.zeros((hp, wp, kw["n_channels"]), device=z.device), z, z, z.int())
        return out if inference else out[:2]

    real = getattr(rmod, name)
    setattr(rmod, name, capture)
    try:
        with torch.no_grad():
            rmod.rasterize(splats, params, torch.zeros(3, device=params.w2c.device), mode="cuda",
                           tile_size=tile_size, instance_cap=instance_cap, with_depth=with_depth,
                           projection="ut", gut_exact=True, inference=inference)
    finally:
        setattr(rmod, name, real)
    return seen[0]


def parity_breakdown(splats, cam, cap: int, frame, train_bin, dense, card: str) -> None:
    """Where the forward frame's image (P5 on the inference binning)
    differs from the dense oracle's (on the training binning): the stream
    form (P5 and the oracle on the same training binning) and the binning
    (the fused depth key's order against the exact order, both through P5).
    For the worst pixel of each, the instances behind the difference.
    Global-shutter cameras only (the camera origin is every ray's)."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb
    from lichtfeld_studio_tpu_torch.ops.blend_ref import blend_weights
    from lichtfeld_studio_tpu_torch.ops.world_blend import _alphas_world, pack_world_features
    from lichtfeld_studio_tpu_torch.tools.selfcheck_train import PARITY_WITHIN

    stream, rays_d, _, a, kw = capture_world_inputs(splats, cam, tile_size=32, instance_cap=cap)
    *_, ts_i, tc_i, g_i, _ = capture_world_inputs(splats, cam, tile_size=32, instance_cap=cap,
                                                  inference=True)
    lay = kwb._Layout(False)
    wp = kw["grid_w"] * 32
    o = cam.cam_position
    view_z = splats.means @ cam.w2c[2, :3] + cam.w2c[2, 3]

    def worst(x, y):
        e = (x - y).abs()
        per_px = e.amax(-1)
        i = int(per_px.argmax())
        return (f"median {float(e.median()):.3g}, max {float(per_px.max()):.3g}, "
                f"{int((per_px >= PARITY_WITHIN).sum())} pixels >= {PARITY_WITHIN}",
                divmod(i, per_px.shape[1]))

    def tile_list(py, px, starts, counts, gidx):
        t = (py // 32) * kw["grid_w"] + px // 32
        s0, n = int(starts[t]), int(counts[t])
        return gidx[s0:s0 + n].long()

    def stream_alphas(g, pix):
        ones = torch.ones((1, g.shape[0]), dtype=torch.bool, device=g.device)
        return kwb._stream_alphas(stream[g][None], rays_d[pix][None, None], None, ones, lay)[0, :, 0]

    # the stream form: per instance, stream against dense alpha at the worst pixel
    text_s, (py, px) = worst(train_bin, dense)
    g = tile_list(py, px, a.tile_start, a.tile_count, a.gaussian_idx)
    pix = py * wp + px
    al_s = stream_alphas(g, pix)
    f = pack_world_features(splats.means[g], splats.scaling[g], splats.rotation[g],
                            torch.sigmoid(splats.opacity[g].reshape(-1)),
                            torch.zeros((g.shape[0], 3), device=g.device))
    al_d = _alphas_world(f[None], o[None, None], rays_d[pix][None, None])[0, :, 0]
    w_s, _ = blend_weights(al_s[:, None])
    w_d, _ = blend_weights(al_d[:, None])
    gro = kwb._matvec(kwb._frame_matrix(splats.scaling[g], splats.rotation[g]),
                      o[None] - splats.means[g]).norm(dim=-1)
    top = (w_s - w_d).abs()[:, 0].topk(min(3, g.shape[0])).indices
    say(f"[gut] parity, stream form (P5 and the dense oracle on the training binning): {text_s}; "
        f"worst pixel ({px}, {py}), {g.shape[0]} instances in its tile, largest weight gaps: "
        + "; ".join(f"#{int(k)} gaussian {int(g[k])} z {float(view_z[g[k]]):.4f} min scale "
                    f"{float(splats.scaling[g[k]].exp().min()):.3g} |M(o - mean)| "
                    f"{float(gro[k]):.4g} alpha stream {float(al_s[k]):.6f} dense "
                    f"{float(al_d[k]):.6f} weight {float(w_s[k, 0]):.6f} / "
                    f"{float(w_d[k, 0]):.6f}" for k in top) + f" | {card}")

    # the binning: the two orders of the worst pixel's tile, through P5's alphas
    text_b, (py, px) = worst(frame, train_bin)
    pix = py * wp + px
    g_t = tile_list(py, px, a.tile_start, a.tile_count, a.gaussian_idx)
    g_f = tile_list(py, px, ts_i, tc_i, g_i)
    same_set = g_t.shape == g_f.shape and torch.equal(g_t.sort().values, g_f.sort().values)
    moved = int((g_t != g_f).sum()) if g_t.shape == g_f.shape else -1
    c_t = g_t[stream_alphas(g_t, pix) > 0]
    c_f = g_f[stream_alphas(g_f, pix) > 0]
    first = next((i for i in range(min(len(c_t), len(c_f))) if c_t[i] != c_f[i]), None)
    where = "the kept instances come in the same order"
    if first is not None:
        z1, z2 = float(view_z[c_t[first]]), float(view_z[c_f[first]])
        where = (f"the kept instances first differ at #{first}: gaussian {int(c_t[first])} "
                 f"(z {z1:.6f}) in the exact order, {int(c_f[first])} (z {z2:.6f}) in the fused "
                 f"key's, a depth gap of {abs(z1 - z2) / max(z1, z2):.3g} relative")
    say(f"[gut] parity, binning (P5 on the forward frame's fused-key binning against P5 on the "
        f"training binning): {text_b}; worst pixel ({px}, {py}), {g_t.shape[0]} instances in "
        f"its tile, the same set {same_set}, {moved} positions reordered, {len(c_t)} kept at "
        f"that pixel; {where} | {card}")


def profiled_step(tag: str, state, inputs, card: str):
    """One plain train step under torch.profiler: device events, busy
    share, and device ms per stage from the step's own profiler ranges."""
    import torch

    from lichtfeld_studio_tpu_torch.profiling import device_summary, stage_device_ms
    from lichtfeld_studio_tpu_torch.train.state import StepFlags, train_step

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = train_step(state, *inputs, StepFlags())
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    d = device_summary(prof, top=8)
    if d is None:
        say(f"[{tag}] one plain step under the profiler: the trace holds no device events "
            f"(launches and stage ms per step not measured) | {card}")
        return state
    say(f"[{tag}] one plain step under the profiler: {d['events']} device events "
        f"({d['copies']} copies/fills), device time summed {d['summed_us'] / 1e3:.3f} ms, "
        f"busy (union) {d['busy_us'] / 1e3:.3f} ms over a span of {d['span_us'] / 1e3:.3f} "
        f"ms; wall under the profiler {traced_ms:.2f} ms | {card}")
    for name, count, us in d["top"]:
        say(f"[{tag}]   {us / 1e3:7.3f} ms {count:4d}x  {name[:100]}")
    stage = stage_device_ms(prof)
    say(f"[{tag}] stage device ms of that step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(stage.items(), key=lambda kv: -kv[1]))
        + f"; not linked to a host op {d['summed_us'] / 1e3 - sum(stage.values()):.3f} "
        f"| {card}")
    return state


def p4_bound_and_library(rows, off, out):
    """P4's bound (the used rows, the offsets and the sums, one float add
    per used value) and the time of torch.segment_reduce on the same
    rows: ((ms, bound_by), library ms)."""
    import torch

    used = int(off[-1])
    rows_used, off64 = rows[:used], off.long()
    ref = torch.segment_reduce(rows_used, "sum", offsets=off64)
    if not torch.allclose(ref, out, rtol=1e-4, atol=1e-4 * float(out.abs().max())):
        fail("torch.segment_reduce disagrees with P4")
    return (bound(nbytes(rows_used, off, out), rows_used.numel()),
            cuda_ms(lambda: torch.segment_reduce(rows_used, "sum", offsets=off64)))


def check_p5(label: str, fwd, kw):
    """P5 against its plain version on one input: (kernel's outputs, max
    |diff|, plain ms of one run)."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb

    t0 = time.perf_counter()
    plain = kwb.world_blend_forward_plain(*fwd, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    kern = kwb.world_blend_forward(*fwd, **kw)
    torch.cuda.synchronize()
    err = max(float((k - q).abs().max()) for k, q in zip(kern[:3], plain[:3]))
    if not (torch.isfinite(kern[0]).all() and err <= P5_CHECK_TOL
            and torch.equal(kern[3], plain[3])):
        fail(f"P5 disagrees with its plain version at {label}: max |diff| {err}, last index "
             f"equal {torch.equal(kern[3], plain[3])}")
    return kern, err, plain_ms


def check_world_kernels(label: str, stream, rays_d, tau, a, kw, card: str, time_them=False):
    """P5 and P6 -> P4 against their plain versions on the training path's
    inputs: returns their errors, plain ms and, with `time_them`, kernel ms
    and bounds."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import segment_reduce as kseg
    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb

    fwd = (stream, rays_d, tau, a.tile_start, a.tile_count, a.gaussian_idx)
    kern, p5_err, p5_plain_ms = check_p5(label, fwd, kw)
    _, _, t_final, last = kern
    gen = torch.Generator(device=stream.device).manual_seed(kw["tile_size"])
    d_image = torch.randn(kern[0].shape, generator=gen, device=stream.device)
    d_alpha = torch.randn(t_final.shape, generator=gen, device=stream.device)
    grid = {k: kw[k] for k in ("grid_w", "grid_h", "tile_size")}
    bwd = (*fwd, a.slot_layout, t_final, last, d_image, d_alpha)
    t0 = time.perf_counter()
    g_p = kseg.segment_reduce_plain(kwb.world_blend_backward_plain(*bwd, **grid), a.segment_off)
    torch.cuda.synchronize()
    p6_plain_ms = 1e3 * (time.perf_counter() - t0)
    rows = kwb.world_blend_backward(*bwd, **grid)
    g_k = kseg.segment_reduce(rows, a.segment_off)
    torch.cuda.synchronize()
    groups = stream_column_groups(stream.shape[1], kw["n_channels"] == 4)
    p6_rel = max(float((g_k[:, c] - g_p[:, c]).abs().max() / g_p[:, c].abs().max())
                 for c in groups)
    if not (torch.isfinite(g_k).all() and p6_rel <= P6_CHECK_REL):
        fail(f"P6 -> P4 disagrees with the plain backward at {label}: {p6_rel} > {P6_CHECK_REL} "
             "of the largest gradient")
    out = {"p5_err": p5_err, "p6_rel": p6_rel, "p5_plain_ms": p5_plain_ms,
           "p6_plain_ms": p6_plain_ms}
    if time_them:
        out["p5_ms"] = cuda_ms(lambda: kwb.world_blend_forward(*fwd, **kw))
        out["p6_ms"] = cuda_ms(lambda: kwb.world_blend_backward(*bwd, **grid))
        out["p4_ms"] = cuda_ms(lambda: kseg.segment_reduce(rows, a.segment_off))
        out["p4_plain_ms"] = cuda_ms(lambda: kseg.segment_reduce_plain(rows, a.segment_off))
        walked, counted = forward_pairs(world_groups(stream, rays_d, tau, a, kw))
        walked_bwd = backward_pairs(last)
        out["pairs"] = {"forward_walked": walked, "backward_walked": walked_bwd,
                        "counted": counted}
        out["p5_bound"] = bound(nbytes(*fwd, *kern), blend_ops("P5", walked, counted))
        out["p6_bound"] = bound(nbytes(*bwd, rows), blend_ops("P6", walked_bwd, counted))
        out["p4_bound"], out["p4_lib_ms"] = p4_bound_and_library(rows, a.segment_off, g_k)
        out["n_instances"] = int(a.n_instances)
        out["rows"] = tuple(rows.shape)
    say(f"[P5] {label}: {int(a.n_instances)} instances, max |kernel - plain| {p5_err:.3g} <= "
        f"{P5_CHECK_TOL}, last counted index equal; plain {p5_plain_ms:.1f} ms (1 run)"
        + (f"; kernel {out['p5_ms']:.3f} ms, bound {out['p5_bound'][0]:.4f} ms "
           f"({out['p5_bound'][1]}; pairs {out['pairs']})" if time_them else "") + f" | {card}")
    say(f"[P6] {label}: P6 -> P4 against the plain backward (autograd through the dense "
        f"stream blend, float64 segment sums), per group max |diff| {p6_rel:.3g} of the largest "
        f"gradient <= {P6_CHECK_REL}; plain {p6_plain_ms:.1f} ms (1 run)"
        + (f"; P6 kernel {out['p6_ms']:.3f} ms, bound {out['p6_bound'][0]:.4f} ms "
           f"({out['p6_bound'][1]}), P4 on its {out['rows'][1]} columns "
           f"{out['p4_ms']:.3f} ms (plain {out['p4_plain_ms']:.3f} ms, torch.segment_reduce "
           f"{out['p4_lib_ms']:.3f} ms)" if time_them else "") + f" | {card}")
    return out


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


def microbench_phase(dev, card: str) -> dict:
    """[T1] [T2] [T3]: every microbenchmark kernel against its plain version
    at its tool's shapes (each tool's own check, tolerances as its test),
    its time, its plain version's and the library yardstick's at the
    card-filling grid, its bound, and the ratios the tools print. Then the
    tools' own entry points are driven with the counts at 0."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import microbench as mb
    from lichtfeld_studio_tpu_torch.tools import (
        microbench_bf16_vpu as t1, microbench_dma_stream as t2, microbench_scan_orient as t3)

    out = {}
    slab = mb.DEPTH * mb.WIDTH
    # --- T1a, T1b
    try:  # on the slabs that are timed, at 2 and at 64 repetitions
        t1_errs = [t1.check(dev, gg) for gg in t1.GRIDS]
    except RuntimeError as e:
        fail(f"T1: {e}")
    t1_err = {kind: max(e[name] for e in t1_errs for name, k, _ in t1.VARIANTS if k == kind)
              for kind in ("alu", "scan")}
    g = t1.GRIDS[-1]
    ms = {gg: t1.measure(dev, gg) for gg in t1.GRIDS}
    ratios = {gg: t1.report(ms[gg], gg, log=lambda m: say(f"[T1] {m} | {card}")) for gg in t1.GRIDS}
    x = t1.slabs(g, dev)
    e32, e16, s32m, s32s, s16m, s16s = ms[g].values()
    moved = 2 * g * slab * 4
    out["alu"] = dict(
        err=t1_err["alu"], ms=e32, ms_bf16=e16,
        plain_ms=cuda_ms(lambda: mb.alu_elementwise_plain(x), reps=1, warmup=1),
        plain_ms_bf16=cuda_ms(lambda: mb.alu_elementwise_plain(x, dtype="bf16"), reps=1, warmup=1),
        bound=bound(moved, g * slab * 4 * mb.REPS),
        bound_bf16=bound(moved, g * slab * 4 * mb.REPS, BF16X2_FLOPS),
        ms_g64=list(ms[t1.GRIDS[0]].values())[0], ms_bf16_g64=list(ms[t1.GRIDS[0]].values())[1],
        ratios={str(gg): ratios[gg] for gg in t1.GRIDS})
    scan_ops = g * mb.WIDTH * mb.REPS * (7 * mb.DEPTH + mb.DEPTH)
    out["scan"] = dict(
        err=t1_err["scan"], ms=s32s, ms_smem=s32m, ms_bf16=s16s, ms_bf16_smem=s16m,
        plain_ms=cuda_ms(lambda: mb.scan_prod_plain(x), reps=1, warmup=1),
        library_ms=cuda_ms(lambda: torch.cumprod(x, dim=1)),
        bound=bound(moved, scan_ops), bound_bf16=bound(moved, scan_ops, BF16X2_FLOPS),
        ms_g64=list(ms[t1.GRIDS[0]].values())[3])
    say(f"[T1] G={g}: alu f32 {e32:.4f} ms (bound {out['alu']['bound'][0]:.4f}, plain "
        f"{out['alu']['plain_ms']:.2f}), bf16x2 {e16:.4f} (bound {out['alu']['bound_bf16'][0]:.4f}); "
        f"scan f32 shuffles {s32s:.4f} ms (bound {out['scan']['bound'][0]:.4f}, plain "
        f"{out['scan']['plain_ms']:.1f}, one torch.cumprod {out['scan']['library_ms']:.3f}), "
        f"shared memory {s32m:.4f}; at G={list(t1.GRIDS)} every variant equals its plain version to "
        f"the bit at {t1.CHECK_REPS} repetitions | {card}")
    del x

    # --- T2
    try:
        rows = t2.run_all(dev, log=lambda m: say(f"[T2] {m} | {card}"))
    except RuntimeError as e:
        fail(f"T2: {e}")
    by = {(r["label"], r["blocks"]): r for r in rows}
    full, one = by["row8", t2.GRID], by["row8", 1]
    out["stream"] = dict(
        err=max(r["rel_err"] for r in rows), ms=full["ms"], library_ms=full["clone_ms"],
        bound=bound(full["bytes"] + 4 * t2.GRID, full["chunks"]),
        gb_s=full["gb_s"], one_block_gb_s=one["gb_s"], one_block_ms=one["ms"],
        row8_over_blk={"1": one["us_per_chunk"] / by["blk", 1]["us_per_chunk"],
                       str(t2.GRID): full["us_per_chunk"] / by["blk", t2.GRID]["us_per_chunk"]},
        layouts={f"{r['label']}_x{r['blocks']}": {k: r[k] for k in ("ms", "us_per_chunk", "gb_s")}
                 for r in rows})
    x = t2.make(8, t2.CHUNKW, t2.NB * t2.GRID_SCALE, dev)
    out["stream"]["plain_ms"] = cuda_ms(
        lambda: mb.stream_ring_plain(x, width=t2.CHUNKW, blocks=t2.GRID), reps=3)
    del x
    say(f"[T2] row8 / blk time per chunk: one block {out['stream']['row8_over_blk']['1']:.2f}x, "
        f"{t2.GRID} blocks {out['stream']['row8_over_blk'][str(t2.GRID)]:.2f}x; one block "
        f"{one['gb_s']:.1f} GB/s, {t2.GRID} blocks {full['gb_s']:.1f} GB/s (bound "
        f"{out['stream']['bound'][0]:.4f} ms, kernel {full['ms']:.4f}) | {card}")

    # --- T3
    try:
        t3_err = {o: max(t3.check(dev, o, gg) for gg in t3.GRIDS) for o in ("lanes", "thread")}
    except RuntimeError as e:
        fail(f"T3: {e}")
    ms3 = {gg: t3.measure(dev, gg) for gg in t3.GRIDS}
    ratio3 = {str(gg): t3.report(ms3[gg], gg, log=lambda m: say(f"[T3] {m} | {card}"))
              for gg in t3.GRIDS}
    g3 = t3.GRIDS[-1]
    x = t3.slabs(g3, "thread", dev)
    moved3 = (2 * x.numel() + g3 * t3.PIXELS) * 4
    out["orient"] = dict(
        err=max(t3_err.values()), ms=ms3[g3]["thread"], ms_lanes=ms3[g3]["lanes"],
        plain_ms=cuda_ms(lambda: mb.scan_orient_plain(x, orient="thread"), reps=1, warmup=1),
        bound=bound(moved3, 8 * x.numel() * mb.REPS), lanes_speedup=ratio3,
        ms_g64=ms3[t3.GRIDS[0]]["thread"], ms_lanes_g64=ms3[t3.GRIDS[0]]["lanes"])
    del x
    say(f"[T3] G={g3}: serial {out['orient']['ms']:.4f} ms (bound {out['orient']['bound'][0]:.4f}, "
        f"plain {out['orient']['plain_ms']:.1f}), lanes {out['orient']['ms_lanes']:.4f} ms; "
        f"max relative error at G={list(t3.GRIDS)} {t3_err} | {card}")

    # --- the tools' own entry points, counts at 0
    counters = {"alu_elementwise": mb.alu_elementwise, "scan_prod": mb.scan_prod,
                "stream_ring": mb.stream_ring, "scan_orient": mb.scan_orient}
    for fn in counters.values():
        fn.launches = 0
    for tool in (t1, t2, t3):
        if tool.main() != 0:
            fail(f"{tool.__name__}.main() failed")
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    if min(out["launches"].values()) < 1:
        fail(f"the tools did not run every microbenchmark kernel: {out['launches']}")
    say(f"[T1-T3] the three tools' entry points ran; launches {out['launches']} | {card}")
    return out


TRAINER_ARGS = ["--headless", "--eval", "--test-every", "8", "--random", "--init-num-pts", "600000",
                "--max-cap", "1000000", "--instance-cap", "1400000", "--sh-degree", "3",
                "--start-refine", "5", "--refine-every", "10", "--stop-refine", "35",
                "--eval-steps", "40", "--save-steps", "40", "--save-state-every", "40"]


def trainer_phase(dev, card: str, counters: dict, bench_plain_ms: float, bench_it_s: float) -> dict:
    """[trainer]: the trainer entry point at full width through the CLI's
    main(argv): an 8-view 1296x840 transforms.json dataset rendered by the
    port from bench_train's scene, 40 iterations from 600k random points
    with eval, PLY and state snapshot; then --resume from the snapshot, one
    warm dispatch and one under the profiler."""
    import contextlib
    import io
    import re
    import shutil

    import numpy as np
    import torch

    from lichtfeld_studio_tpu_torch import bench_train, cli
    from lichtfeld_studio_tpu_torch.core import events
    from lichtfeld_studio_tpu_torch.io.ply import read_ply
    from lichtfeld_studio_tpu_torch.profiling import device_summary, stage_device_ms
    from lichtfeld_studio_tpu_torch.tools.selfcheck_train import (
        orbit_cameras, write_transforms_scene)
    from lichtfeld_studio_tpu_torch.train.state import StepFlags, train_step
    from lichtfeld_studio_tpu_torch.train.trainer import Trainer

    root = WORK / "trainer"
    shutil.rmtree(root, ignore_errors=True)
    scene, out_dir = root / "scene", root / "out"
    t0 = time.perf_counter()
    with torch.no_grad():
        gt_splats = bench_train.bench_setup(dev)[0]
        write_transforms_scene(
            scene, gt_splats,
            orbit_cameras(8, 8.0, 1000.0, bench_train.WIDTH, bench_train.HEIGHT, lift=0.0),
            instance_cap=bench_train.ICAP)
    del gt_splats
    say(f"[trainer] dataset: 8 views {bench_train.WIDTH}x{bench_train.HEIGHT} of bench_train's "
        f"scene written in {time.perf_counter() - t0:.1f} s")

    argv = ["-d", str(scene), "-o", str(out_dir), *TRAINER_ARGS, "--iterations", "40"]
    stamps = {}
    h = events.bus().when(events.TrainingProgress,
                          lambda e: stamps.setdefault(e.iteration, time.perf_counter()))
    for fn in counters.values():
        fn.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            rc = cli.main(argv)
    finally:
        events.bus().off(events.TrainingProgress, h)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    text = log.getvalue()
    for line in text.splitlines():
        if line.startswith(("[", "done")):
            say(f"[trainer]   {line}")
    if rc != 0:
        fail(f"trainer: the CLI returned {rc}\n{text[-2000:]}")
    losses = [float(m) for m in re.findall(r"^iter +\d+ +loss (\S+)", text, re.MULTILINE)]
    counts = [int(m) for m in re.findall(r"^iter +\d+ +loss \S+ +gaussians (\d+)", text, re.MULTILINE)]
    if len(losses) != 40 or not np.isfinite(losses).all() or "[health]" in text:
        fail(f"trainer: {len(losses)} progress lines, losses finite "
             f"{bool(np.isfinite(losses).all())}, health line {'[health]' in text}")
    if min(launches.values()) < 40:
        fail(f"trainer: a kernel of the path was launched fewer than 40 times: {launches}")
    n_ply = read_ply(out_dir / "splat_40.ply").size
    rows = (out_dir / "metrics.csv").read_text().strip().splitlines()
    psnr, ssim = (float(v) for v in rows[-1].split(",")[1:3]) if len(rows) == 2 else (np.nan, np.nan)
    if not (n_ply >= 600_000 and len(rows) == 2 and np.isfinite([psnr, ssim]).all()):
        fail(f"trainer: splat_40.ply holds {n_ply} gaussians, metrics.csv {rows}")
    # growth on the refine steps (10, 20, 30), none between them
    grew = [i + 1 for i in range(1, 40) if counts[i] > counts[i - 1]]
    if not (counts[-1] > counts[0] and set(grew) <= {10, 20, 30} and grew):
        fail(f"trainer: live counts {counts[0]} -> {counts[-1]}, grew at {grew}")
    for name in ("report.txt", "project.lfs", "state_40/state.pt"):
        if not (out_dir / name).exists():
            fail(f"trainer: {name} was not written")
    steps = np.diff([stamps[i] for i in range(10, 41)])
    steady_it_s = 30.0 / (stamps[40] - stamps[10])
    median_ms = 1e3 * float(np.median(steps))
    say(f"[trainer] cli {' '.join(argv[4:])}: rc 0 in {run_s:.1f} s (random init with kNN scales, "
        f"40 iterations, eval, PLY, snapshot); losses {losses[0]:.4f} -> {losses[-1]:.4f} finite, "
        f"no health line; gaussians {counts[0]} -> {counts[-1]}, grew at {grew}; splat_40.ply "
        f"{n_ply} gaussians; eval PSNR {psnr:.3f} SSIM {ssim:.4f}; launches {launches} | {card}")
    say(f"[trainer] iterations 11-40 (3 refine steps among them): {steady_it_s:.2f} it/s, median "
        f"step {median_ms:.2f} ms ({1e3 / median_ms:.2f} it/s) by the host clock at each "
        f"dispatch's read; bench_train in this run: plain step {bench_plain_ms:.2f} ms, "
        f"{bench_it_s:.2f} it/s amortised at 1 refine per 100: the difference is the loader, "
        f"the H2D copy and the per-dispatch reads | {card}")

    # --resume from the snapshot: restores on the card, and further steps run
    with contextlib.redirect_stdout(log):
        trainer = Trainer.setup(cli.parse_args_and_params(
            ["-d", str(scene), "-o", str(root / "out_resume"), *TRAINER_ARGS, "--iterations", "42",
             "--resume", str(out_dir / "state_40")]), dev)
    if trainer.state.iteration != 40 or int(trainer.state.splats.n_active) != counts[-1]:
        fail(f"trainer: resume restored iteration {trainer.state.iteration}, "
             f"{int(trainer.state.splats.n_active)} gaussians")
    bg = torch.zeros(3, device=dev)
    trainer.start_loader()
    try:
        def dispatch():
            m = trainer.run_dispatch(1, StepFlags(), bg)
            return torch.stack([m[k].to(torch.float64) for k in
                                ("n_nonfinite", "n_instances", "n_active", "loss")]).tolist()

        row = dispatch()  # the one more step
        if not (row[0] == 0 and np.isfinite(row[3]) and trainer.state.iteration == 41):
            fail(f"trainer: the step after the resume: {row}")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            row = dispatch()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        # where the trainer's step time goes beside bench_train's: 20
        # dispatches as the trainer runs them (a read after each), 20 without
        # the read, 20 steps on one view already on the card (no loader, no
        # copy, no read), each between two synchronises
        def timed(fn, n=20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / n

        def step_alone():
            trainer.state, _ = train_step(trainer.state, view, image, bg, trainer.cfg, StepFlags())

        split = {"with_read_ms": timed(dispatch),
                 "no_read_ms": timed(lambda: trainer.run_dispatch(1, StepFlags(), bg))}
        cam, img = next(trainer._loader)
        view, image = cam.device_params(dev), trainer._to_device(img)
        split["step_alone_ms"] = timed(step_alone)
    finally:
        trainer.stop_loader()
    say(f"[trainer] 20 steps each, host clock: a dispatch with its read {split['with_read_ms']:.2f} "
        f"ms, without the read {split['no_read_ms']:.2f} ms, the step alone on a view already on "
        f"the card {split['step_alone_ms']:.2f} ms: the read costs "
        f"{split['with_read_ms'] - split['no_read_ms']:.2f} ms a step, the loader and the copy "
        f"{split['no_read_ms'] - split['step_alone_ms']:.2f} ms | {card}")
    d = device_summary(prof, top=4)
    result = {"it_s": steady_it_s, "median_ms": median_ms, "launches": launches, "psnr": psnr,
              "ssim": ssim, **split}
    if d is None:
        say(f"[trainer] resume: iteration 40 restored, steps 41 and 42 ran (loss {row[3]:.4f}); "
            f"the trace holds no device events | {card}")
        return result
    stage = stage_device_ms(prof)
    host_share = 1.0 - d["busy_us"] / 1e3 / wall_ms
    say(f"[trainer] resume: iteration 40 restored, steps 41 and 42 ran (loss {row[3]:.4f}); one "
        f"trainer dispatch (loader, H2D copy, step, read) under the profiler: wall {wall_ms:.2f} "
        f"ms, {d['events']} device events ({d['copies']} copies/fills), device busy "
        f"{d['busy_us'] / 1e3:.3f} ms: host share {100 * host_share:.1f}% | {card}")
    say("[trainer] stage device ms of that dispatch: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(stage.items(), key=lambda kv: -kv[1])) + f" | {card}")
    result.update(host_share=host_share, wall_ms=wall_ms, device_events=d["events"])
    return result


def selfcheck_phase(dev, card: str) -> dict:
    """[selfcheck]: tools/selfcheck_train.py's protocol at its own size:
    MCMC with the SSIM gate and both kernel-parity gates on the trained
    model, then the ADC strategy across one opacity reset."""
    import contextlib
    import io
    import shutil

    from lichtfeld_studio_tpu_torch.tools import selfcheck_train

    root = WORK / "selfcheck"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for strategy, iters in (("mcmc", SELFCHECK_ITERS), ("default", SELFCHECK_ADC_ITERS)):
        lines = []
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()) as text:
                r = selfcheck_train.run(root, iters, strategy, dev, parity=strategy == "mcmc",
                                        log=lines.append)
        except AssertionError as e:
            fail(f"selfcheck ({strategy}, {iters} iterations): a gate failed: {e}")
        if "[health]" in text.getvalue():
            fail(f"selfcheck ({strategy}): a health line was printed")
        # growth: the run, which crosses an opacity reset and the prune of
        # the refine after it, ends with more gaussians than it began with
        if strategy == "default" and not r["num_gaussians"] > r["n_init"]:
            fail(f"selfcheck (default): no growth: {r['n_init']} -> least "
                 f"{r['min_gaussians']} -> {r['num_gaussians']}")
        parity = (f"; kernel parity median {r['parity'][0]:.3g}, within 0.05 "
                  f"{r['parity'][1]:.5f}; world-blend parity median {r['world_parity'][0]:.3g}, "
                  f"within 0.05 {r['world_parity'][1]:.5f}" if "parity" in r else "")
        say(f"[selfcheck] {strategy}, {iters} iterations, 24 views 512x384, max-cap 200k: "
            f"{time.perf_counter() - t0:.1f} s, {r['iters_per_s']:.2f} it/s, gaussians "
            f"{r['n_init']} -> {r['num_gaussians']} (least {r['min_gaussians']}), PSNR {r['psnr']}, SSIM {r['ssim']}, final "
            f"loss {r['final_loss']:.4f}{parity} | {card}")
        out[strategy] = r
    return out



def main() -> int:
    global cuda_ms
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        from lichtfeld_studio_tpu_torch.kernels import _build
        from lichtfeld_studio_tpu_torch.kernels import blend as kblend
        from lichtfeld_studio_tpu_torch.kernels import expand as kexpand
        from lichtfeld_studio_tpu_torch.profiling import device_ms as cuda_ms
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
        # reads n_touched and the payload, writes owner, rank and payload
        # per slot; a binary search of ~log2(N) steps per slot
        p1_bound = bound(nbytes(nt, payload, g_k, r_k, pl_k),
                         cap_p1 * 2 * max(nt.shape[0], 2).bit_length())
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
        p2_pairs = forward_pairs(blend_groups(args, kw), kblend.INFERENCE_TERM_THRESHOLD)
        p2_bound = bound(nbytes(*args, img4, alpha), blend_ops("P2", *p2_pairs))
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
            if sd is sd_b:  # the bounds at the train path's size
                walked, counted = forward_pairs(blend_groups(args, kw))
                p3_pairs = {"forward_walked": walked, "backward_walked": backward_pairs(last),
                            "counted": counted}
                p2t_bound = bound(nbytes(*args, *kern), blend_ops("P2", walked, counted))
                p3_bound = bound(nbytes(*bwd, rows),
                                 blend_ops("P3", p3_pairs["backward_walked"], counted))
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
        p4_bound, p4_lib_ms = p4_bound_and_library(rows, a.segment_off, s4_k)
        p2t_big_ms, p2t_big_plain_ms, p3_big_ms, p3_big_plain_ms = (
            p2t_ms, p2t_plain_ms, p3_ms, p3_plain_ms)
        say(f"[P4] {n_seg} gaussians, {int(a.n_instances)} instances, cap {rows.shape[0]}, "
            f"{rows.shape[1]} columns: max |kernel - plain| {p4_rel:.3g} of the largest sum <= "
            f"{P4_CHECK_REL}; kernel {p4_ms:.3f} ms, plain {p4_plain_ms:.3f} ms, "
            f"torch.segment_reduce {p4_lib_ms:.3f} ms, bound {p4_bound[0]:.4f} ms "
            f"({p4_bound[1]}) | {card}")
        say(f"[P3] bounds at {checks[-1][0]}: P2-train {p2t_bound[0]:.4f} ms ({p2t_bound[1]}), P3 "
            f"{p3_bound[0]:.4f} ms ({p3_bound[1]}); pairs {p3_pairs}; P2 at {W}x{H} (inference "
            f"stop) {p2_bound[0]:.4f} ms ({p2_bound[1]}), pairs walked and counted {p2_pairs} "
            f"| {card}")
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
    profiled_step("train", state, (cam_t, gt_t, bg_t, cfg_t), card)
    del state
    bench_plain_ms, bench_it_s = r["plain_ms"], r["it_s"]

    # --- 8. the world-blend kernels against their plain versions -------------
    import dataclasses

    from lichtfeld_studio_tpu_torch import bench_gut
    from lichtfeld_studio_tpu_torch.core.camera import CameraModelType, ShutterType
    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb

    world = {"p5_err": 0.0, "p6_rel": 0.0}
    with torch.no_grad():
        sd_w, cam_w = check_scene(dev, n=20_000, seed=1, size=256, fx=300.0)
        cam_w.camera_model = CameraModelType.OPENCV_FISHEYE
        cam_w.radial_distortion = np.asarray(bench_gut.FISHEYE_RADIAL, np.float32)
        base = cam_w.device_params(dev)
        w2c_end = base.w2c.clone()
        w2c_end[0, 3] += 0.2  # the camera moves during the frame
        rolling = dataclasses.replace(base, w2c_end=w2c_end,
                                      shutter_type=ShutterType.ROLLING_TOP_TO_BOTTOM)
        for ts, params, depth, what in ((16, base, False, "global"), (32, base, True, "global"),
                                        (16, rolling, True, "rolling"),
                                        (32, rolling, False, "rolling")):
            inputs = capture_world_inputs(sd_w, params, tile_size=ts, instance_cap=1 << 20,
                                          with_depth=depth)
            r_w = check_world_kernels(f"256x256 fisheye {what} shutter, {ts}-px tiles, "
                                      f"{3 + depth} channels", *inputs, card)
            world = {k: max(world[k], r_w[k]) for k in world}
        # the slice's own shape: bench_gut's scene through its fisheye camera
        sd_g, cam_g, _, _, cfg_g, _ = bench_gut.bench_setup(dev)
        label_g = f"{cam_g.width}x{cam_g.height} fisheye, {cfg_g.tile_size}-px tiles"
        inputs = capture_world_inputs(sd_g, cam_g, tile_size=cfg_g.tile_size,
                                      instance_cap=cfg_g.instance_cap)
        big = check_world_kernels(label_g, *inputs, card, time_them=True)
        # and on the forward frame's own inputs (the inference binning)
        *fwd_f, kw_f = capture_world_inputs(sd_g, cam_g, tile_size=cfg_g.tile_size,
                                            instance_cap=cfg_g.instance_cap, inference=True)
        _, err_f, plain_f_ms = check_p5(f"{label_g}, the forward frame's binning", fwd_f, kw_f)
        big["p5_frame_ms"] = cuda_ms(lambda: kwb.world_blend_forward(*fwd_f, **kw_f))
        world = {k: max(world[k], big[k]) for k in world}
        world["p5_err"] = max(world["p5_err"], err_f)
        say(f"[P5] {label_g}, the forward frame's inputs (inference binning, "
            f"{int(fwd_f[4].sum())} instances): max |kernel - plain| {err_f:.3g} <= "
            f"{P5_CHECK_TOL}, last counted index equal; kernel {big['p5_frame_ms']:.3f} ms, "
            f"plain {plain_f_ms:.1f} ms (1 run) | {card}")
        del sd_w, sd_g, inputs, fwd_f

    # --- 9. main path: the --gut-exact train step and forward frame ----------
    gut_counters = {"expand_instances": kexpand.expand_instances,
                    "segment_reduce": kseg.segment_reduce,
                    "world_blend_forward": kwb.world_blend_forward,
                    "world_blend_backward": kwb.world_blend_backward}
    for fn in gut_counters.values():
        fn.launches = 0
    r = bench_gut.benchmark_gut(dev, frames=5, k_scan=10, warmup=1, dispatches=3, refine_warm=1,
                                refine_timed=2, log=lambda msg: say(f"[gut] {msg}"))
    torch.cuda.synchronize()
    gut_launches = {k: fn.launches for k, fn in gut_counters.items()}
    state = r.pop("state")
    if not (r["all_losses_finite"] and r["max_n_nonfinite"] == 0
            and r["max_n_instances"] <= r["instance_cap"] and r["forward_finite"]
            and r["forward_n_instances"] <= r["instance_cap"]):
        fail(f"gut: unhealthy steps {r}")
    if min(gut_launches.values()) < 1:
        fail(f"the gut-exact path did not run every kernel: {gut_launches}")
    if not r["n_active_after_refine"] > r["n_active_before_refine"]:
        fail(f"gut: refine steps did not grow the model: {r}")
    cam_t, gt_t, bg_t, cfg_t = r.pop("inputs")
    say(f"[gut] {r['steps']} steps on {r['device']}: plain {r['plain_ms']:.2f} ms/step, refine "
        f"{r['refine_ms']:.2f} ms/step, amortised {r['amortized_ms']:.2f} ms/step -> "
        f"{r['it_s']:.3f} it/s; loss {r['loss_first']:.4f} -> {r['loss_last']:.4f}; max "
        f"instances {r['max_n_instances']} <= cap {r['instance_cap']}; n_nonfinite 0; n_active "
        f"{r['n_active_before_refine']} -> {r['n_active_after_refine']} over "
        f"{r['refine_steps']} refine steps; forward frame {r['forward_ms']:.3f} ms "
        f"({r['forward_fps']:.2f} FPS, {r['forward_n_instances']} instances); launches "
        f"{gut_launches} | {card}")
    say(json.dumps({"metric": bench_gut.METRIC, "value": round(r["it_s"], 3), "unit": "it/s",
                    "forward_fps": round(r["forward_fps"], 2)}))
    state = profiled_step("gut", state, (cam_t, gt_t, bg_t, cfg_t), card)

    # --- 10. the world-blend parity gate on the trained model -----------------
    # the forward frame (P5) against the dense world_blend_tiles oracle (exact
    # per-pixel origins, no k_max cut) through the fisheye camera,
    # tools/selfcheck_train.py:144-168; then where the two differ
    from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize as rast
    from lichtfeld_studio_tpu_torch.tools import selfcheck_train
    from lichtfeld_studio_tpu_torch.tools.selfcheck_train import (
        PARITY_FRAC, PARITY_MEDIAN, PARITY_WITHIN)

    with torch.no_grad():
        kw_r = dict(tile_size=32, instance_cap=cfg_t.instance_cap, projection="ut",
                    gut_exact=True)
        a_img = rast(state.splats, cam_t, bg_t, mode="cuda", inference=True, **kw_r).image
        b_img = rast(state.splats, cam_t, bg_t, mode="oracle", **kw_r).image
        t_img = rast(state.splats, cam_t, bg_t, mode="cuda", **kw_r).image
    # the gate itself: the function tools/selfcheck_train.py gates with
    med_w, frac_w = selfcheck_train.kernel_parity(
        state.splats, cam_t, instance_cap=cfg_t.instance_cap, gut_exact=True, tile_size=32)
    if not selfcheck_train.parity_ok(med_w, frac_w):
        fail(f"world-blend parity: median |P5 - dense| {med_w} (< {PARITY_MEDIAN}), within "
             f"{PARITY_WITHIN}: {frac_w} (> {PARITY_FRAC})")
    say(f"[gut] world-blend parity on the trained model ({int(state.splats.n_active)} live), "
        f"{cam_t.width}x{cam_t.height} fisheye: median |P5 - dense oracle| {med_w:.3g} < "
        f"{PARITY_MEDIAN}, within {PARITY_WITHIN}: {frac_w:.5f} > {PARITY_FRAC} | {card}")
    with torch.no_grad():
        parity_breakdown(state.splats, cam_t, cfg_t.instance_cap, a_img, t_img, b_img, card)
    del state, a_img, b_img, t_img

    torch.cuda.empty_cache()

    # --- 11. the microbenchmark kernels T1a, T1b, T2, T3 ----------------------
    micro = microbench_phase(dev, card)

    # --- 12. main path: the trainer through the CLI at full width -------------
    trainer_r = trainer_phase(dev, card, counters, bench_plain_ms, bench_it_s)
    torch.cuda.empty_cache()

    # --- 13. the self-check's protocol: MCMC, then ADC ------------------------
    selfcheck_phase(dev, card)

    tl = trainer_r["launches"]
    by_path = {
        "expand_instances": {"render": launches["expand_instances"],
                             "train": train_launches["expand_instances"],
                             "gut": gut_launches["expand_instances"],
                             "trainer": tl["expand_instances"]},
        "blend_forward": {"render": launches["blend_forward"],
                          "train": train_launches["blend_forward"],
                          "trainer": tl["blend_forward"]},
        "blend_backward": {"train": train_launches["blend_backward"],
                           "trainer": tl["blend_backward"]},
        "segment_reduce": {"train": train_launches["segment_reduce"],
                           "gut": gut_launches["segment_reduce"],
                           "trainer": tl["segment_reduce"]},
        "world_blend_forward": {"gut": gut_launches["world_blend_forward"]},
        "world_blend_backward": {"gut": gut_launches["world_blend_backward"]},
        **{k: {"tools": v} for k, v in micro["launches"].items()},
    }

    def entry(name, source, replaces, err, ms, plain_ms, bnd, library_ms=None, **extra):
        if not replaces.startswith("tools/"):
            replaces = f"lichtfeld_studio_tpu/kernels/{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"lichtfeld_studio_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library_ms, **extra}

    kernels = [
        entry("expand_instances", "expand.cu", "expand_pallas.py:67", float(p1_err), p1_ms,
              p1_plain_ms, p1_bound, shape="render: 660k gaussians, 1080p view 0"),
        entry("blend_forward", "blend_forward.cu", "blend_pallas.py:293",
              max(p2_err, big_err, p2t_err), p2_ms, p2_plain_ms, p2_bound,
              max_abs_err_inference=max(p2_err, big_err), max_abs_err_train=p2t_err,
              ms_train=p2t_big_ms, plain_ms_train=p2t_big_plain_ms, bound_ms_train=p2t_bound[0],
              pairs={"forward_walked": p2_pairs[0], "counted": p2_pairs[1]},
              pairs_train={k: p3_pairs[k] for k in ("forward_walked", "counted")},
              shape="render 1080p view 0 (train: 1296x840 bench scene)"),
        entry("blend_backward", "blend_backward.cu", "blend_pallas.py:514", p3_rel, p3_big_ms,
              p3_big_plain_ms, p3_bound,
              max_err_is="relative to the largest plain gradient of each group", pairs=p3_pairs,
              shape="1296x840 bench scene, 32-px tiles"),
        entry("segment_reduce", "segment_reduce.cu", "segment_reduce.py:72", p4_rel, p4_ms,
              p4_plain_ms, p4_bound, p4_lib_ms, max_err_is="relative to the largest plain sum",
              shape=f"P3's rows of the 1296x840 bench scene, {n_seg} gaussians",
              ms_gut=big["p4_ms"], plain_ms_gut=big["p4_plain_ms"],
              bound_ms_gut=big["p4_bound"][0], library_ms_gut=big["p4_lib_ms"]),
        entry("world_blend_forward", "world_blend_forward.cu", "world_blend_pallas.py:330",
              world["p5_err"], big["p5_ms"], big["p5_plain_ms"], big["p5_bound"],
              ms_forward_frame=big["p5_frame_ms"], pairs=big["pairs"],
              shape="1296x840 fisheye bench_gut scene, 32-px tiles, training binning"),
        entry("world_blend_backward", "world_blend_backward.cu", "world_blend_pallas.py:431",
              world["p6_rel"], big["p6_ms"], big["p6_plain_ms"], big["p6_bound"],
              max_err_is="P6 -> P4, relative to the largest plain gradient of each group",
              pairs=big["pairs"], shape="1296x840 fisheye bench_gut scene, 32-px tiles"),
    ]
    alu, scan, stream, orient = (micro[k] for k in ("alu", "scan", "stream", "orient"))
    kernels += [
        entry("alu_elementwise", "microbench_alu.cu", "tools/microbench_bf16_vpu.py:36",
              alu["err"], alu["ms"], alu["plain_ms"], alu["bound"],
              ms_bf16=alu["ms_bf16"], plain_ms_bf16=alu["plain_ms_bf16"],
              bound_ms_bf16=alu["bound_bf16"][0], ms_g64=alu["ms_g64"],
              ms_bf16_g64=alu["ms_bf16_g64"], ratios=alu["ratios"],
              shape="264 slabs [128, 1024] f32, 64 reps (g64: the original's grid of 64)"),
        entry("scan_prod", "microbench_alu.cu", "tools/microbench_bf16_vpu.py:74",
              scan["err"], scan["ms"], scan["plain_ms"], scan["bound"], scan["library_ms"],
              library_is="one torch.cumprod over the same slabs (the kernel does 64)",
              ms_smem=scan["ms_smem"], ms_bf16=scan["ms_bf16"], ms_bf16_smem=scan["ms_bf16_smem"],
              bound_ms_bf16=scan["bound_bf16"][0], ms_g64=scan["ms_g64"],
              shape="264 slabs [128, 1024] f32, 64 reps, lane shuffles"),
        entry("stream_ring", "microbench_stream.cu", "tools/microbench_dma_stream.py:37",
              stream["err"], stream["ms"], stream["plain_ms"], stream["bound"],
              stream["library_ms"], library_is="torch.clone of the same bytes",
              max_err_is="relative to the sum of |values|", gb_s=stream["gb_s"],
              one_block_ms=stream["one_block_ms"], one_block_gb_s=stream["one_block_gb_s"],
              row8_over_blk=stream["row8_over_blk"], layouts=stream["layouts"],
              shape="row8: 65536 chunks [8, 128] f32 (256 MB), 264 blocks"),
        entry("scan_orient", "microbench_scan.cu", "tools/microbench_scan_orient.py:60",
              orient["err"], orient["ms"], orient["plain_ms"], orient["bound"],
              max_err_is="relative to the largest plain value", ms_lanes=orient["ms_lanes"],
              ms_g64=orient["ms_g64"], ms_lanes_g64=orient["ms_lanes_g64"],
              lanes_speedup=orient["lanes_speedup"],
              shape="528 slabs [128, 1024] f32, 64 reps, serial in a thread"),
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
