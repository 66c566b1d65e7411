#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the CUDA
kernels, checks each against its plain PyTorch version, drives the headless
render path through the CLI at 1920x1080 on the 660k-gaussian SH-3 scene of
tools/bench_render.py and times it, drives the MCMC train step at
bench.py's geometry (1M capacity, 600k live, 1296x840) through
bench_train.benchmark_train and times it, then drives the --gut-exact
train step and forward frame through an OpenCV-fisheye camera at the same
geometry (tools/bench_world_blend.py's) through bench_gut.benchmark_gut.
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
PARITY_MEDIAN, PARITY_WITHIN, PARITY_FRAC = 2e-3, 0.05, 0.995  # selfcheck_train.py:144-168
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
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


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for a kernel's bytes and
    float32 operations."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
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

    with torch.no_grad():
        kw_r = dict(tile_size=32, instance_cap=cfg_t.instance_cap, projection="ut",
                    gut_exact=True)
        a_img = rast(state.splats, cam_t, bg_t, mode="cuda", inference=True, **kw_r).image
        b_img = rast(state.splats, cam_t, bg_t, mode="oracle", **kw_r).image
        t_img = rast(state.splats, cam_t, bg_t, mode="cuda", **kw_r).image
        err_w = (a_img - b_img).abs()
        med_w, frac_w = float(err_w.median()), float((err_w < PARITY_WITHIN).float().mean())
    if not (med_w < PARITY_MEDIAN and frac_w > PARITY_FRAC):
        fail(f"world-blend parity: median |P5 - dense| {med_w} (< {PARITY_MEDIAN}), within "
             f"{PARITY_WITHIN}: {frac_w} (> {PARITY_FRAC})")
    say(f"[gut] world-blend parity on the trained model ({int(state.splats.n_active)} live), "
        f"{cam_t.width}x{cam_t.height} fisheye: median |P5 - dense oracle| {med_w:.3g} < "
        f"{PARITY_MEDIAN}, within {PARITY_WITHIN}: {frac_w:.5f} > {PARITY_FRAC} | {card}")
    with torch.no_grad():
        parity_breakdown(state.splats, cam_t, cfg_t.instance_cap, a_img, t_img, b_img, card)
    del state, a_img, b_img, t_img, err_w

    by_path = {
        "expand_instances": {"render": launches["expand_instances"],
                             "train": train_launches["expand_instances"],
                             "gut": gut_launches["expand_instances"]},
        "blend_forward": {"render": launches["blend_forward"],
                          "train": train_launches["blend_forward"]},
        "blend_backward": {"train": train_launches["blend_backward"]},
        "segment_reduce": {"train": train_launches["segment_reduce"],
                           "gut": gut_launches["segment_reduce"]},
        "world_blend_forward": {"gut": gut_launches["world_blend_forward"]},
        "world_blend_backward": {"gut": gut_launches["world_blend_backward"]},
    }

    def entry(name, source, replaces, err, ms, plain_ms, bnd, library_ms=None, **extra):
        return {"name": name, "route": "cuda",
                "source": f"lichtfeld_studio_tpu_torch/csrc/{source}",
                "replaces": f"lichtfeld_studio_tpu/kernels/{replaces}",
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
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
