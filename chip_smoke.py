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
state snapshot, then a resume); the trainer again on that dataset with the
four training components (--pose-optimization direct --bilateral-grid
--bg-modulation --sparsity, 60 iterations: refines at 10, 20, 30, the ADMM
phase from 41, the final prune; pose and grids must move on the train
views and not on the held-out one, a resume must restore the components'
state bit for bit); the exact path's ORTHO and pose-gradient cases at
256x256 (the dense route against the UT frame and against P5); and
tools/selfcheck_train.py's protocol (24 views 512x384, MCMC 2000
iterations with its SSIM and kernel-parity gates, then a shorter ADC run
across one opacity reset); last the live-viewer path (`[live]`): SOG of
the render scene written with its k-means on the card and read back,
`-v scene.sog`, `-v a.ply,b.ply` and the `.html` export through the CLI,
the coherent renderer at 1920x1080 against the exact frames, the live
server around the trainer on the [trainer] dataset, and the studio
session.
P1 runs at the render shape and at the train step's (1M capacity, cap
1.4M), beside torch.searchsorted on the same ends and slots. P3, P5 and P6
are also launched twice on equal inputs (the outputs must be bit-equal);
the counting instances of P2, P3, P5 and P6 say what share of (warp,
instance) pairs their reach tests skipped, and P2's, P5's and P6's fail
the run if a skipped pair held a pixel that would have counted (also
through the plain mirrors of the tests at the timed shapes). P2-train, P3,
P5 and P6 run again on the binning of the models the train and gut phases
leave after their steps and refines. P4 is also held against its plain version
on the adversarial segment layouts of segment_cases(), which the tests
share.
Each kernel's line carries its least time on the card (bound_ms: the larger
of its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s, the
H100 SXM data sheet, counted from this run's inputs; for the blends only
the pairs that a plain mirror of the reach tests keeps are evaluated).

    python3 chip_smoke.py

Exits non-zero, printing no result, without a CUDA device or without the
package beside it. The line before the last is the card's name and power
limit, and before it a JSON line with one entry per kernel. The last line
is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
# The least work of a blend, in float32 operations counted from the
# kernels' code. Each (warp patch, instance) pair up to the patch's last
# walked instance is tested once: PATCH_OPS (P2 and P3 the reach box against
# the patch; P5 and P6 the ray-space bound at the patch's centre ray, y_c,
# z_c, their norms, the slack and the test). Only the (pixel, instance)
# pairs inside (patch, instance) pairs that the test keeps are evaluated:
# PAIR_OPS (P2 and P3 sigma and its two limits; P5 and P6 y and z, |y|^2,
# |z|^2, the division and the test). Each pair that counts takes
# COUNTED_OPS more (P2 and P3 exp, scale, clamp and the alpha test, which a
# pair above the sigma limit skips, then the compositing or the backward
# terms). Which pairs the test keeps comes from plain mirrors of the
# kernels' tests (kernels/blend.py::reach_2d_plain, kernels/world_blend.py::
# patch_ray_skip_group). The reach of each instance at the gather is not
# counted. P5 and P6 at a global
# shutter, as the main path runs them.
# P5 evaluates y and |y|^2 (20) for each pair inside a kept patch, and z,
# |z|^2, the clamp, the division, the sum and the test (24) only for those
# its |y|^2 test does not drop (FULL_OPS; kernels/world_blend.py::
# pixel_reject_group mirrors that test).
PATCH_OPS = {"P2": 4, "P3": 4, "P5": 60, "P6": 60}
PAIR_OPS = {"P2": 10, "P3": 10, "P5": 20, "P6": 44}
FULL_OPS = {"P5": 24}
COUNTED_OPS = {"P2": 19, "P3": 57, "P5": 18, "P6": 79}


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


def blend_ops(kernel: str, work: dict, walk: str) -> int:
    """Float32 operations of `kernel` on blend_work's counts for its walk
    ("forward" or "backward")."""
    return (PATCH_OPS[kernel] * work[f"{walk}_tests"] + PAIR_OPS[kernel] * work[f"{walk}_kept"]
            + FULL_OPS.get(kernel, 0) * work[f"{walk}_full"] + COUNTED_OPS[kernel] * work["counted"])


def blend_work(groups, ts: int, threshold: float = 0.0) -> dict:
    """What this run's data asks of a blend, from a plain version's
    per-group alphas and a plain mirror of the reach test: `groups` yields
    (alphas [t, K, P], in_range [t, K], tile_count [t], skip [t, 8, K]) and,
    for the world blend, the pairs P5 drops on |y|^2 alone [t, K, P]. A
    forward walk takes each pixel up to the instance that ends it (all of
    them if none does; to within one pair a pixel), a backward walk up to
    its last counted one. For each walk: the (pixel, instance) pairs walked,
    those inside (patch, instance) pairs the test keeps, and the (patch,
    instance) tests, each patch's up to its last walked instance. Also the
    pairs that count, the (patch, instance) pairs in range and skipped, and
    the pairs that pass the alpha test inside skipped ones (`lost`, 0
    unless the mirror is not conservative; `forward_lost` those of them
    before the pixel's forward walk ends, which the forward would have
    evaluated). `*_full`: the kept pairs that P5's |y|^2 test does not drop
    (all kept pairs without that test), and `reject_lost` the pairs that
    pass the alpha test among the dropped ones (0 unless it is not
    conservative)."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels.blend import _patch_pixels
    from lichtfeld_studio_tpu_torch.ops.blend_ref import blend_weights

    keys = ("forward_walked", "forward_kept", "forward_full", "forward_tests", "backward_walked",
            "backward_kept", "backward_full", "backward_tests", "counted", "patch_pairs",
            "skipped", "lost", "forward_lost", "reject_lost")
    out = dict.fromkeys(keys, 0)
    patch_pix = patch_of = None
    for alphas, in_range, count, skip, *rejected in groups:
        if patch_pix is None:
            patch_pix = _patch_pixels(ts, alphas.device)  # [8, n]
            patch_of = torch.empty(ts * ts, dtype=torch.long, device=alphas.device)
            patch_of[patch_pix.reshape(-1)] = torch.arange(
                8, device=alphas.device).repeat_interleave(patch_pix.shape[1])
        _, counted = blend_weights(alphas, threshold)
        counted &= in_range[..., None]  # a prefix of each pixel's range
        hit = counted & (alphas > 0.0)
        k = torch.arange(alphas.shape[1], device=alphas.device)[None, :, None]
        keep = ~skip[:, patch_of].transpose(1, 2)  # [t, K, P]
        ends = {"forward": torch.minimum(counted.sum(dim=1) + 1, count[:, None].long()),
                "backward": torch.where(hit, k + 1, 0).amax(dim=1)}  # [t, P]
        full = keep & ~rejected[0] if rejected else keep
        for walk, end in ends.items():
            out[f"{walk}_walked"] += int(end.sum())
            out[f"{walk}_kept"] += int(((k < end[:, None, :]) & keep).sum())
            out[f"{walk}_full"] += int(((k < end[:, None, :]) & (full if walk == "forward"
                                                                   else keep)).sum())
            out[f"{walk}_tests"] += int(end[:, patch_pix].amax(dim=-1).sum())
        out["counted"] += int(hit.sum())
        out["patch_pairs"] += 8 * int(in_range.sum())
        out["skipped"] += int(skip.sum())
        out["lost"] += int(((alphas > 0.0) & ~keep).sum())
        out["forward_lost"] += int(((alphas > 0.0) & ~keep & (k < ends["forward"][:, None, :])).sum())
        if rejected:
            out["reject_lost"] += int(((alphas > 0.0) & rejected[0]).sum())
    return out


def blend_groups(args, kw):
    """The 2D blend's per-group alphas (P2's plain version's pieces) and the
    (patch, instance) pairs the plain mirror of its reach test skips."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import blend as kblend

    tile_start, tile_count, gidx, mean2d, conic, opacity, _ = args
    ts = kw["tile_size"]
    box = kblend.reach_2d_plain(mean2d, conic, opacity)
    for t0, t1, k_max in kblend._plain_groups(tile_count, ts * ts):
        _, in_range, g, _, px, py = kblend._gather_group(t0, t1, k_max, tile_start, tile_count,
                                                         gidx, kw["grid_w"], ts)
        alphas = kblend.compute_alphas(mean2d[g], conic[g], torch.where(in_range, opacity[g], 0.0),
                                       px, py)
        skip = kblend.patch_reach_skip_group(box[g], in_range, t0, t1, kw["grid_w"], ts)
        yield alphas, in_range, tile_count[t0:t1], skip


def world_groups(stream, rays_d, tau, a, kw):
    """The world blend's per-group alphas (P5's plain version's pieces) and
    the (patch, instance) pairs the plain mirror of the ray-space bound of
    P5 and P6 skips."""
    from lichtfeld_studio_tpu_torch.kernels import blend as kblend
    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb

    import torch

    ts = kw["tile_size"]
    lay = kwb._Layout(stream.shape[1] == kwb.STREAM_ROWS_RS)
    d_t, tau_t = kwb._tile_rays(rays_d, tau, kw["grid_w"], kw["grid_h"], ts)
    patch_pix = kblend._patch_pixels(ts, stream.device)
    patch_of = torch.empty(ts * ts, dtype=torch.long, device=stream.device)
    patch_of[patch_pix.reshape(-1)] = torch.arange(
        8, device=stream.device).repeat_interleave(patch_pix.shape[1])
    for t0, t1, k_max in kblend._plain_groups(a.tile_count, ts * ts):
        _, in_range, g, _, _, _ = kblend._gather_group(t0, t1, k_max, a.tile_start, a.tile_count,
                                                       a.gaussian_idx, kw["grid_w"], ts)
        f, d, tau_g = stream[g], d_t[t0:t1], tau_t[t0:t1] if tau_t is not None else None
        skip, den_hi = kwb.patch_ray_skip_group(f, d, tau_g, in_range, lay, patch_pix,
                                                with_den_hi=True)
        yield (kwb._stream_alphas(f, d, tau_g, in_range, lay), in_range, a.tile_count[t0:t1],
               skip, kwb.pixel_reject_group(f, d, tau_g, lay, den_hi, patch_of))


def pair_summary(work: dict) -> str:
    """blend_work's counts in a line: walked / inside kept patches, counted."""
    return (f"forward {work['forward_walked']} walked / {work['forward_kept']} inside kept "
            f"patches / {work['forward_full']} past P5's |y|^2 test, backward "
            f"{work['backward_walked']} / {work['backward_kept']}, "
            f"{work['counted']} counted; the plain reach mirror skips {work['skipped']} of "
            f"{work['patch_pairs']} (patch, instance) pairs, {work['lost']} passing pairs inside")


def check_mirror(kernel: str, label: str, work: dict) -> None:
    """Fail where the plain mirror of a reach test dropped a pair that
    passes the alpha test."""
    if work["lost"] != 0 or work["reject_lost"] != 0:
        fail(f"{kernel} at {label}: the plain mirror of the reach test (or of P5's |y|^2 test) "
             f"drops pairs that pass the alpha test: {work}")


def stream_column_groups(n_rows: int, with_depth: bool) -> list[slice]:
    """The column groups of a world-blend stream row and of its gradient
    (kernels/world_blend.py): C' (C0' and C1' with a rolling shutter), M,
    -log2 op, the colour, and the depth channel where it is rendered."""
    geo = [slice(0, 9), slice(9, 18)] + ([slice(18, 27)] if n_rows == 32 else [])
    c = 28 if n_rows == 32 else 19
    return geo + [slice(c - 1, c), slice(c, c + 3)] + ([slice(c + 3, c + 4)] if with_depth else [])


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
    from lichtfeld_studio_tpu_torch.ops.rasterize import capture_world_inputs
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
    # the tile ranking that P2, P3 and P6 launch ahead of themselves
    # (csrc/blend_common.cuh): its device time, and its launches' host time
    # at the step's mean cudaLaunchKernel
    kinds = torch.autograd.DeviceType
    ranks = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == kinds.CUDA and "tile_order_kernel" in e.name]
    calls = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == kinds.CPU and e.name == "cudaLaunchKernel"]
    per_call = sum(calls) / max(len(calls), 1)
    say(f"[{tag}] tile ranking: {len(ranks)} launches, {sum(ranks):.1f} us on the device; host "
        f"~{len(ranks) * per_call:.1f} us at the step's mean cudaLaunchKernel of {per_call:.2f} us "
        f"({len(calls)} calls traced), of {traced_ms:.2f} ms under the profiler | {card}")
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


def segment_cases() -> dict:
    """Segment layouts P4's blocks and chunks must survive, as name ->
    (n_touched int32 [N], instance cap): a block of csrc/segment_reduce.cu
    owns BLOCK_GAUSSIANS gaussians and streams CHUNK_FLOATS // columns rows
    a chunk. Shared with the tests (tests/torch_parity.py)."""
    import numpy as np

    from lichtfeld_studio_tpu_torch.kernels.segment_reduce import BLOCK_GAUSSIANS as G

    rng = np.random.default_rng(6)
    long_segment = rng.integers(0, 3, 40).astype(np.int32)
    long_segment[17] = 1100  # > two chunks of 9-column rows (455 each), > eight of 32-column
    flat = rng.integers(0, 4, G + 90).astype(np.int32)  # off is flat from the cap on
    across = rng.integers(0, 3, 2 * G + 8).astype(np.int32)
    across[G - 1], across[G] = 60, 350  # long segments on both sides of a block's edge
    across[G + 1:G + 40] = 0  # and a run of empty ones behind it
    return {
        "segment_longer_than_two_chunks": (long_segment, int(long_segment.sum()) + 3),
        "all_segments_empty": (np.zeros(G + 44, np.int32), 64),
        "flat_from_the_cap_on": (flat, int(flat[:G - 20].sum()) + 1),
        "segments_across_a_block_edge": (across, int(across.sum())),
        "n_not_a_multiple_of_the_block": (rng.integers(0, 4, G + 37).astype(np.int32), 1024),
        "one_gaussian": (np.array([17], np.int32), 32),
    }


SEGMENT_COLUMNS = (1, 9, 10, 24, 32)  # the run-time width, P3's two, P6's two


def segment_inputs(name: str, n_columns: int, scale: int = 1):
    """(rows [cap, n_columns] f32, n_touched int32, cap) of a segment_cases
    entry as numpy arrays, its gaussians repeated `scale` times."""
    import numpy as np

    nt, cap = segment_cases()[name]
    nt, cap = np.tile(nt, scale), cap * scale
    rows = np.random.default_rng(n_columns + len(name)).normal(size=(cap, n_columns))
    return rows.astype(np.float32), nt, cap


def check_p4_cases(dev) -> float:
    """P4 against its plain version on every segment_cases layout, at every
    width, as it stands and repeated 40 times (many blocks); two launches
    must give the same bits. Returns the largest error, relative to the
    largest plain sum (or to 1 where every sum is smaller)."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import segment_reduce as kseg
    from lichtfeld_studio_tpu_torch.ops.tiles import segment_offsets

    worst = 0.0
    for name in segment_cases():
        for n_columns in SEGMENT_COLUMNS:
            for scale in (1, 40):
                rows, nt, cap = segment_inputs(name, n_columns, scale)
                rows = torch.from_numpy(rows).to(dev)
                off = segment_offsets(torch.from_numpy(nt).to(dev), cap)
                plain = kseg.segment_reduce_plain(rows, off)
                out = kseg.segment_reduce(rows, off)
                torch.cuda.synchronize()
                rel = float((out - plain).abs().max()) / max(float(plain.abs().max()), 1.0)
                if not (rel <= P4_CHECK_REL and torch.equal(out, kseg.segment_reduce(rows, off))):
                    fail(f"P4 on the layout {name}, {n_columns} columns, x{scale}: {rel} > "
                         f"{P4_CHECK_REL} of the largest sum, or two launches differ")
                worst = max(worst, rel)
    return worst


def check_p5(label: str, fwd, kw, need_skip: bool = False):
    """P5 against its plain version on one input (the image, alpha and
    T_final within P5_CHECK_TOL, the last counted index equal), two launches
    bit-equal, and its ray-space skip from the counting instance (no pixel,
    not yet done, inside a skipped pair whose evaluation passes the keep
    test; with `need_skip`, some pairs skipped): (kernel's outputs, max
    |diff|, plain ms of one run, skip counts)."""
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
    if not all(torch.equal(k, q) for k, q in zip(kern, kwb.world_blend_forward(*fwd, **kw))):
        fail(f"P5 at {label}: two launches on equal inputs differ")
    skip = kwb.world_blend_forward_skip_stats(*fwd, **kw)
    if skip["lost"] != 0 or (need_skip and not skip["skipped"] > 0):
        fail(f"P5 at {label}: the ray-space skip dropped keepable pixels or skipped nothing: {skip}")
    return kern, err, plain_ms, skip


def skip_text(skip: dict) -> str:
    """A counting instance's skip counts in words."""
    return (f"ray-space skip {skip['skipped']} of {skip['warp_pairs']} (warp, instance) pairs "
            f"walked ({100 * skip['skipped'] / max(skip['warp_pairs'], 1):.1f}%), {skip['lost']} "
            f"lost")


def check_p1(label: str, nt, payload, cap: int, card: str) -> dict:
    """P1 against its plain version on one input, and its times beside
    torch.searchsorted (tools/ab_kernels.py::expand_check); the plain
    version's time and the bound."""
    from lichtfeld_studio_tpu_torch.kernels import expand as kexpand
    from lichtfeld_studio_tpu_torch.tools.ab_kernels import expand_check

    out = expand_check(nt, payload, cap)
    if not out["exact"]:
        fail(f"P1 disagrees with its plain version at {label}, or an owner is out of bounds")
    out["plain_ms"] = cuda_ms(lambda: kexpand.expand_instances_plain(nt, payload, cap))
    # reads n_touched and the payload, writes owner, rank and payload per
    # slot; two operations a merge step
    out["bound"] = bound(nbytes(nt, payload, *out.pop("outputs")), 2 * (nt.shape[0] + cap))
    say(f"[P1] {label}: {out['n'][0]} gaussians, {out['n'][1]} instances, cap {cap}: equal on "
        f"{out['valid']} valid slots; kernel {out['kernel_ms']:.4f} ms (torch.searchsorted on "
        f"the same ends and slots {out['library_ms']:.4f} ms, the owner only; the wrapper with "
        f"the cumsum {out['ms']:.4f} ms, host-bound), bound {out['bound'][0]:.4f} ms "
        f"({out['bound'][1]}), plain {out['plain_ms']:.3f} ms | {card}")
    return out


def check_p2_train(label: str, a, args, kw, card: str, with_pairs=False):
    """P2's training variant against its plain version on one binning (the
    image, alpha and T_final within P2_CHECK_TOL, the last counted index
    equal), its reach skip from the counting instance (no pair that would
    pass the alpha test inside a skipped one): (kernel's outputs, max
    |diff|, plain ms of one run, kernel ms, skip counts, and with
    `with_pairs` blend_work's counts, after the plain reach mirror's check)."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import blend as kblend

    t0 = time.perf_counter()
    plain = kblend.blend_forward_plain(*args, **kw, train=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    kern = kblend.blend_forward(*args, **kw, train=True)
    torch.cuda.synchronize()
    err = max(float((k - q).abs().max()) for k, q in zip(kern[:3], plain[:3]))
    if not (torch.isfinite(kern[0]).all() and err <= P2_CHECK_TOL
            and torch.equal(kern[3], plain[3])):
        fail(f"P2-train disagrees with its plain version at {label}: max |diff| {err}, last "
             f"index equal {torch.equal(kern[3], plain[3])}")
    skip = kblend.blend_forward_skip_stats(*args, **kw, train=True)
    if skip["lost"] != 0:
        fail(f"P2-train at {label}: the reach skip dropped pairs that pass the alpha test: {skip}")
    ms = cuda_ms(lambda: kblend.blend_forward(*args, **kw, train=True))
    pairs = blend_work(blend_groups(args, kw), kw["tile_size"]) if with_pairs else None
    if pairs:
        check_mirror("P2-train", label, pairs)
    say(f"[P2-train] {label}, {int(a.n_instances)} instances: max |kernel - plain| {err:.3g} <= "
        f"{P2_CHECK_TOL}, last counted index equal; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms "
        f"(1 run); reach skip {skip['skipped']} of {skip['warp_pairs']} (warp, instance) pairs "
        f"walked ({100 * skip['skipped'] / max(skip['warp_pairs'], 1):.1f}%), {skip['lost']} "
        f"lost" + (f"; pairs: {pair_summary(pairs)}" if pairs else "") + f" | {card}")
    return (kern, err, plain_ms, ms, skip) + ((pairs,) if with_pairs else ())


def check_world_kernels(label: str, stream, rays_d, tau, a, kw, card: str, time_them=False):
    """P5 and P6 -> P4 against their plain versions on the training path's
    inputs: returns their errors, plain ms and, with `time_them`, kernel ms
    and bounds."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import segment_reduce as kseg
    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb

    fwd = (stream, rays_d, tau, a.tile_start, a.tile_count, a.gaussian_idx)
    kern, p5_err, p5_plain_ms, p5_skip = check_p5(label, fwd, kw, need_skip=time_them)
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
    if not torch.equal(rows, kwb.world_blend_backward(*bwd, **grid)):
        fail(f"P6 at {label}: two launches on equal inputs differ")
    # the ray-space skip: the kernel's counting instance, and (timed shapes)
    # the plain mirror of its bound over every tile's whole range
    skip = kwb.world_blend_backward_skip_stats(*bwd, **grid)
    if skip["lost"] != 0:
        fail(f"P6 at {label}: the ray-space skip dropped pairs P5 counted: {skip}")
    mirror = (blend_work(world_groups(stream, rays_d, tau, a, kw), kw["tile_size"])
              if time_them else None)
    if mirror:
        check_mirror("P6", label, mirror)
    out = {"p5_err": p5_err, "p6_rel": p6_rel, "p5_plain_ms": p5_plain_ms,
           "p6_plain_ms": p6_plain_ms, "p6_skip": skip, "p5_skip": p5_skip}
    if time_them:
        out["p5_ms"] = cuda_ms(lambda: kwb.world_blend_forward(*fwd, **kw))
        out["p6_ms"] = cuda_ms(lambda: kwb.world_blend_backward(*bwd, **grid))
        out["p4_ms"] = cuda_ms(lambda: kseg.segment_reduce(rows, a.segment_off))
        out["p4_plain_ms"] = cuda_ms(lambda: kseg.segment_reduce_plain(rows, a.segment_off))
        if mirror["backward_walked"] != int((last.long() + 1).sum()):
            fail(f"P6 at {label}: the plain walk ends disagree with P5's last counted indices")
        out["pairs"] = mirror
        out["p5_bound"] = bound(nbytes(*fwd, *kern), blend_ops("P5", mirror, "forward"))
        out["p6_bound"] = bound(nbytes(*bwd, rows), blend_ops("P6", mirror, "backward"))
        out["p4_bound"], out["p4_lib_ms"] = p4_bound_and_library(rows, a.segment_off, g_k)
        out["n_instances"] = int(a.n_instances)
        out["rows"] = tuple(rows.shape)
    say(f"[P5] {label}: {int(a.n_instances)} instances, max |kernel - plain| {p5_err:.3g} <= "
        f"{P5_CHECK_TOL}, last counted index equal, two launches bit-equal; "
        f"{skip_text(p5_skip)}; plain {p5_plain_ms:.1f} ms (1 run)"
        + (f"; kernel {out['p5_ms']:.3f} ms, bound {out['p5_bound'][0]:.4f} ms "
           f"({out['p5_bound'][1]}; pairs: {pair_summary(mirror)})" if time_them else "")
        + f" | {card}")
    say(f"[P6] {label}: P6 -> P4 against the plain backward (autograd through the dense "
        f"stream blend, float64 segment sums), per group max |diff| {p6_rel:.3g} of the largest "
        f"gradient <= {P6_CHECK_REL}; plain {p6_plain_ms:.1f} ms (1 run)"
        + (f"; P6 kernel {out['p6_ms']:.3f} ms, bound {out['p6_bound'][0]:.4f} ms "
           f"({out['p6_bound'][1]}), P4 on its {out['rows'][1]} columns "
           f"{out['p4_ms']:.3f} ms (plain {out['p4_plain_ms']:.3f} ms, torch.segment_reduce "
           f"{out['p4_lib_ms']:.3f} ms)" if time_them else "") + f"; two launches bit-equal | {card}")
    say(f"[P6] {label}: ray-space skip (the kernel's counting instance): of {skip['warp_pairs']} "
        f"(warp, instance) pairs walked, {skip['skipped']} "
        f"({100 * skip['skipped'] / max(skip['warp_pairs'], 1):.1f}%) skipped, {skip['lost']} "
        f"pixels P5 counted inside skipped pairs, {skip['reduced']} ended in a warp reduction"
        + (f"; the plain mirror over whole ranges: {mirror['skipped']} of {mirror['patch_pairs']} "
           f"(patch, instance) pairs skipped, {mirror['lost']} passing pairs inside them"
           if mirror else "") + f" | {card}")
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


COMPONENT_ARGS = ["--pose-optimization", "direct", "--bilateral-grid", "--bg-modulation",
                  "--sparsity", "--sparsify-steps", "20", "--iterations", "60", "--eval-steps", "60",
                  "--save-steps", "60", "--save-state-every", "60"]


def components_phase(dev, card: str, counters: dict, scene: Path, plain_it_s: float) -> dict:
    """[components]: the trainer through the CLI's main(argv) with all four
    training components on the [trainer] phase's dataset: 60 iterations,
    refines at 10, 20 and 30, the sparsity phase from 41 (ADMM init at 41,
    an update at 50), eval, PLY and snapshot at 60 and the final prune; then
    a resume from the snapshot, one profiled dispatch and what the grid's
    slice and the sparsity term cost at this width."""
    import contextlib
    import io
    import re
    import shutil

    import numpy as np
    import torch

    from lichtfeld_studio_tpu_torch import cli
    from lichtfeld_studio_tpu_torch.core import events
    from lichtfeld_studio_tpu_torch.io.ply import read_ply
    from lichtfeld_studio_tpu_torch.profiling import stage_device_ms
    from lichtfeld_studio_tpu_torch.train.components import sparsity
    from lichtfeld_studio_tpu_torch.train.components.bilateral_grid import (
        identity_grids, slice_grid)
    from lichtfeld_studio_tpu_torch.train.state import step_flags
    from lichtfeld_studio_tpu_torch.train.trainer import Trainer

    root = WORK / "components"
    shutil.rmtree(root, ignore_errors=True)
    out_dir = root / "out"
    argv = ["-d", str(scene), "-o", str(out_dir), *TRAINER_ARGS, *COMPONENT_ARGS]
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
            say(f"[components]   {line}")
    if rc != 0:
        fail(f"components: the CLI returned {rc}\n{text[-2000:]}")
    losses = [float(m) for m in re.findall(r"^iter +\d+ +loss (\S+)", text, re.MULTILINE)]
    counts = [int(m) for m in re.findall(r"^iter +\d+ +loss \S+ +gaussians (\d+)", text, re.MULTILINE)]
    if len(losses) != 60 or not np.isfinite(losses).all() or "[health]" in text:
        fail(f"components: {len(losses)} progress lines, losses finite "
             f"{bool(np.isfinite(losses).all())}, health line {'[health]' in text}")
    if min(launches.values()) < 60:
        fail(f"components: a kernel of the path was launched fewer than 60 times: {launches}")
    grew = [i + 1 for i in range(1, 60) if counts[i] != counts[i - 1]]
    if not (grew and set(grew) <= {10, 20, 30} and counts[-1] > counts[0]):
        fail(f"components: live counts {counts[0]} -> {counts[-1]}, changed at {grew}")
    n60 = counts[-1]
    want = n60 - int(np.float32(0.6) * np.float32(n60))  # prune_mask's count, in float32
    pruned = re.findall(r"^\[sparsity\] pruned to (\d+) gaussians", text, re.MULTILINE)
    n_ply = read_ply(out_dir / "splat_60.ply").size
    if not (pruned and int(pruned[0]) == want == n_ply):
        fail(f"components: {n60} live before the prune, want {want} after it; printed {pruned}, "
             f"splat_60.ply holds {n_ply}")
    rows = (out_dir / "metrics.csv").read_text().strip().splitlines()
    psnr, ssim = (float(v) for v in rows[-1].split(",")[1:3]) if len(rows) == 2 else (np.nan, np.nan)
    if not np.isfinite([psnr, ssim]).all():
        fail(f"components: metrics.csv {rows}")
    # the snapshot at 60 (before the prune): pose and grids moved on the
    # train views (uids 1-7) and stayed on the held-out view (uid 0)
    snap = torch.load(out_dir / "state_60" / "state.pt", map_location="cpu", weights_only=True)
    emb, grids = snap["aux_params"]["pose.embeddings"], snap["aux_params"]["bilateral"]
    eye = identity_grids(grids.shape[0], grid_w=grids.shape[4], grid_h=grids.shape[3],
                         grid_l=grids.shape[2])
    moved = [bool(emb[u].any()) for u in range(8)]
    grid_moved = [not torch.equal(grids[u], eye[u]) for u in range(8)]
    if moved != [False] + [True] * 7 or grid_moved != [False] + [True] * 7:
        fail(f"components: pose embeddings moved {moved}, grids off identity {grid_moved} "
             "(want the held-out view 0 unmoved, the 7 train views moved)")
    if not (snap["admm_z"].any() and snap["admm_u"].any()):
        fail("components: the ADMM duals of the snapshot are zero")
    it_s = 30.0 / (stamps[40] - stamps[10])
    say(f"[components] cli {' '.join(COMPONENT_ARGS)}: rc 0 in {run_s:.1f} s; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} finite, no health line; gaussians {counts[0]} -> "
        f"{n60}, changed at {grew} only; pruned to {want} = {n60} - floor(0.6 n) (splat_60.ply "
        f"{n_ply}); pose embeddings and grids moved on views 1-7, not on held-out view 0; "
        f"|embedding| max {float(emb.abs().max()):.3g}; eval PSNR {psnr:.3f} SSIM {ssim:.4f}; "
        f"launches {launches} | {card}")
    say(f"[components] iterations 11-40 (3 refine steps among them): {it_s:.2f} it/s by the host "
        f"clock at each dispatch's read; the plain [trainer] phase in this run: "
        f"{plain_it_s:.2f} it/s | {card}")

    # --resume from the snapshot restores the components' state bit for bit
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer.setup(cli.parse_args_and_params(
            ["-d", str(scene), "-o", str(root / "out_resume"), *TRAINER_ARGS, *COMPONENT_ARGS,
             "--iterations", "62", "--resume", str(out_dir / "state_60")]), dev)
    st = trainer.state
    pairs = [(st.aux_params, snap["aux_params"]), (st.admm_u, snap["admm_u"]),
             (st.admm_z, snap["admm_z"])]
    pairs += [(getattr(st.aux_adam, f), snap["aux_adam"][f])
              for f in ("exp_avg", "exp_avg_sq", "step_count", "lr")]

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return torch.equal(a.cpu(), b)

    if st.iteration != 60 or not all(same(a, b) for a, b in pairs):
        fail(f"components: the resume restored iteration {st.iteration}; aux params, aux Adam "
             f"and duals equal: {[same(a, b) for a, b in pairs]}")
    bg = torch.zeros(3, device=dev)
    flags = step_flags(trainer.cfg, 61)
    trainer.start_loader()
    try:
        m = trainer.run_dispatch(1, flags, bg)  # step 61: the sparsity phase, every component
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            m = trainer.run_dispatch(1, step_flags(trainer.cfg, 62), bg)
            torch.cuda.synchronize()
    finally:
        trainer.stop_loader()
    if not (int(m["n_nonfinite"]) == 0 and np.isfinite(float(m["loss"]))):
        fail(f"components: the steps after the resume: {m}")
    stage = stage_device_ms(prof)
    missing = {"bg", "pose", "bilateral", "sparsity"} - set(stage)
    if missing:
        fail(f"components: the profiled dispatch has no {sorted(missing)} stage: {stage}")
    say("[components] resume: aux params, aux Adam and ADMM duals restored with the same bits; "
        "stage device ms of one dispatch (step 62, every component): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(stage.items(), key=lambda kv: -kv[1]))
        + f" | {card}")

    # what the slice and the sparsity term cost at this width, fwd + bwd;
    # and whether two backward passes of the slice give the same bits (the
    # 8-corner gather's backward accumulates with atomics)
    from lichtfeld_studio_tpu_torch.profiling import device_ms

    gen = torch.Generator(device=dev).manual_seed(5)
    grid = (identity_grids(1, device=dev)[0]
            + 0.05 * torch.randn((12, 8, 16, 16), generator=gen, device=dev)).requires_grad_(True)
    view = trainer.train_set.cameras[0]
    rgb = torch.rand((view.height, view.width, 3), generator=gen, device=dev).requires_grad_(True)
    cot = torch.randn(rgb.shape, generator=gen, device=dev)

    def slice_step():
        return torch.autograd.grad(slice_grid(grid, rgb), [grid, rgb], cot)

    g1, g2 = slice_step(), slice_step()
    same_bits = all(torch.equal(a, b) for a, b in zip(g1, g2))
    slice_ms = device_ms(slice_step)
    sp = trainer.state.splats
    admm = sparsity.ADMMState(u=trainer.state.admm_u, z=trainer.state.admm_z)

    def sparsity_step():
        return torch.autograd.grad(sparsity.sparsity_loss(sp.opacity, sp.active_mask(), admm,
                                                          trainer.cfg.sparsity_rho), [sp.opacity])

    sparsity_ms = device_ms(sparsity_step)
    say(f"[components] {rgb.shape[1]}x{rgb.shape[0]}: bilateral slice forward + backward "
        f"{slice_ms:.3f} ms (two backward passes give the same bits: {same_bits}); sparsity term "
        f"forward + backward over {sp.capacity} slots {sparsity_ms:.3f} ms | {card}")
    return {"it_s": it_s, "launches": launches, "stage": stage, "slice_ms": slice_ms,
            "slice_same_bits": same_bits, "sparsity_ms": sparsity_ms, "pruned_to": want}


def exact_cases_phase(dev, card: str) -> dict:
    """[exact-cases], 256x256: an ORTHO --gut-exact frame against the UT
    frame of the same camera; 5 --gut-exact steps on a fisheye camera with
    pose optimisation (the dense route, cam_grad); the dense route at zero
    pose parameters against the P5 frame of the unposed camera."""
    import dataclasses

    import numpy as np
    import torch

    from lichtfeld_studio_tpu_torch.core.camera import CameraModelType
    from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize
    from lichtfeld_studio_tpu_torch.tools.selfcheck_train import parity_ok
    from lichtfeld_studio_tpu_torch.train.state import (
        TrainConfig, init_train_state, make_lrs, posed_camera, step_flags, train_step)
    from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig

    size, cap = 256, 1 << 18
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    kw = dict(mode="cuda", projection="ut", instance_cap=cap, inference=True)

    # ORTHO: every pixel its own ray origin
    sd, cam = check_scene(dev, n=20_000, seed=6, size=size, fx=300.0)
    f_o = size / 6.0  # the scene's [-2.5, 2.5] across the frame
    ortho = dataclasses.replace(cam.device_params(dev), camera_model=CameraModelType.ORTHO,
                                K=torch.tensor([f_o, f_o, size / 2, size / 2], device=dev))
    with torch.no_grad():
        exact = rasterize(sd, ortho, bg, gut_exact=True, **kw)
        ut = rasterize(sd, ortho, bg, **kw)
    diff = (exact.image - ut.image).abs()
    median = float(diff.median())
    a_ex, a_ut = float(exact.alpha.max()), float(ut.alpha.max())
    if not (torch.isfinite(exact.image).all() and median < 0.01
            and abs(a_ex - a_ut) <= 0.1 * a_ut and a_ut > 0.5):
        fail(f"exact-cases: ORTHO exact against UT: median |diff| {median} (< 0.01), alpha max "
             f"{a_ex} against {a_ut} (within 10%)")
    say(f"[exact-cases] ORTHO {cam.width}x{cam.height}, {sd.capacity} gaussians: --gut-exact frame (dense "
        f"route, per-pixel origins) against the UT frame: median |diff| {median:.3g} < 0.01, "
        f"alpha max {a_ex:.4f} against {a_ut:.4f} | {card}")

    # the fisheye camera with pose optimisation: the dense route
    sd, cam = check_scene(dev, n=20_000, seed=7, size=size, fx=300.0)
    cam.uid = 1
    fish = dataclasses.replace(cam.device_params(dev), camera_model=CameraModelType.OPENCV_FISHEYE,
                               radial=torch.tensor([0.08, -0.01, 0.0, 0.0], device=dev))
    cfg = TrainConfig(raster_mode="cuda", tile_size=16, instance_cap=cap, projection="ut",
                      gut_exact=True, pose_mode="direct", pose_lr=1e-3,
                      mcmc=MCMCConfig(max_cap=sd.capacity, start_refine=10**9,
                                      stop_refine=10**9 + 1))
    state = init_train_state(sd, make_lrs(1.6e-4, 2.5e-3, 5e-3, 1e-3, 0.05, sd.scene_scale),
                             cfg=cfg, num_cameras=2)
    posed = posed_camera(fish, cfg, {"embeddings": state.aux_params["pose.embeddings"]})
    with torch.no_grad():
        dense = rasterize(sd, posed, bg, gut_exact=True, cam_grad=True, **kw).image
        frame = rasterize(sd, fish, bg, gut_exact=True, **kw).image
    err = (dense - frame).abs()
    med_p, within = float(err.median()), float((err < 0.05).float().mean())
    if not parity_ok(med_p, within):
        fail(f"exact-cases: zero pose, dense route against the P5 frame: median {med_p}, within "
             f"0.05 {within}")
    gt = torch.rand((cam.height, cam.width, 3), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    losses = []
    for i in range(5):
        state, m = train_step(state, fish, gt, bg, cfg, step_flags(cfg, i + 1))
        losses.append(float(m["loss"]))
    emb = state.aux_params["pose.embeddings"]
    if not (np.isfinite(losses).all() and bool(emb[1].any()) and not bool(emb[0].any())):
        fail(f"exact-cases: fisheye --gut-exact with pose: losses {losses}, embedding {emb}")
    say(f"[exact-cases] fisheye {cam.width}x{cam.height}, {sd.capacity} gaussians: at zero pose the dense route (cam_grad) against "
        f"the P5 frame of the unposed camera: median |diff| {med_p:.3g}, within 0.05 "
        f"{within:.5f}; 5 --gut-exact steps with pose optimisation: losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} finite, |embedding of the posed view| {float(emb[1].abs().max()):.3g}, "
        f"the other view's 0 | {card}")
    return {"ortho_median": median, "pose_parity": (med_p, within), "losses": losses}


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



@contextlib.contextmanager
def uncounted(counters: dict):
    """Launches inside are timing or reference runs, not the path's: the
    counts are restored on the way out."""
    saved = {k: fn.launches for k, fn in counters.items()}
    try:
        yield
    finally:
        for k, fn in counters.items():
            fn.launches = saved[k]


def http(port: int, path: str, body: dict | None = None, timeout: float = 600.0):
    """(status, bytes) of a GET, or of a POST of `body` as JSON, to the
    live server on localhost."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def png_array(body: bytes):
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)))


def u8_gate(img, ref) -> tuple[float, float]:
    """(median |diff|, share within 3 u8) of two u8 frames on the card:
    tests/test_coherent.py's bounds are median <= 1, share > 0.99."""
    import torch

    d = (img.to(torch.int16) - ref.to(torch.int16)).abs()
    return float(d.float().median()), float((d <= 3).float().mean())


LIVE_MAX_REUSE = 25  # the orbit's 60 frames re-bin at frames 0, 26 and 52
LIVE_ORBIT_SPAN = 0.00015  # rad over the 60 frames: drift under the 1 px budget
LIVE_JUMP = 0.8  # rad: far past the drift budget
# the studio's run: 20 iterations from 600k random points at the [trainer] width
LIVE_STUDIO_ARGS = ["--random", "--init-num-pts", "600000", "--max-cap", "1000000",
                    "--instance-cap", "1400000", "-i", "20"]


def live_phase(dev, card: str, splats, counters: dict, scene: Path) -> dict:
    """[live]: the live-viewer path at full width. SOG on the render cell's
    660k SH-3 scene (write with 10 k-means iterations on the card, read,
    the round-trip bounds, `-v scene.sog` through the CLI beside the PLY's
    frame); `-v a.ply,b.ply` of the scene split in two against the whole
    scene's frame; the .html export; CoherentRenderer at 1920x1080 (a slow
    orbit under the drift budget, then a jump; bins as the drift bound and
    max_reuse predict; every frame against the exact frame; P2 on a frame
    pass against its plain version; an in-place write re-bins; FPS beside
    the exact orbit's); the live server around the trainer on the
    [trainer] dataset (render, pause, save, resume, stop, viewer_live.html,
    --sog); the studio session (open the .sog, render, crop, transform,
    save; open the dataset, train 20 iterations, crop the result)."""
    import contextlib
    import io
    import re
    import shutil
    import threading

    import numpy as np
    import torch
    from PIL import features

    from lichtfeld_studio_tpu_torch import bench_render, cli
    from lichtfeld_studio_tpu_torch.core import events
    from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
    from lichtfeld_studio_tpu_torch.io.ply import write_ply
    from lichtfeld_studio_tpu_torch.io.sog import morton_encode, read_sog, write_sog
    from lichtfeld_studio_tpu_torch.kernels import blend as kblend
    from lichtfeld_studio_tpu_torch.ops.rasterize import count_instances
    from lichtfeld_studio_tpu_torch.profiling import device_summary
    from lichtfeld_studio_tpu_torch.render import coherent
    from lichtfeld_studio_tpu_torch.render.bench_scene import (
        HEIGHT as H, WIDTH as W, bench_arrays)
    from lichtfeld_studio_tpu_torch.render.headless import (
        benchmark_fps, render_frame_u8, snug_cap)
    from lichtfeld_studio_tpu_torch.render.live_server import LiveTrainingServer
    from lichtfeld_studio_tpu_torch.render.studio import StudioSession
    from lichtfeld_studio_tpu_torch.train.trainer import Trainer

    root = WORK / "live"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for fn in counters.values():
        fn.launches = 0
    out = {}

    # --- SOG on the render cell's scene --------------------------------------
    if not features.check("webp"):
        fail("live: PIL.features.check('webp') is false: SOG needs PIL's WebP codec")
    arrays = bench_arrays()
    pc = SplatData.from_arrays(*arrays.values(), scene_scale=3.0).to_point_cloud()
    sog = root / "scene.sog"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    write_sog(pc, sog, kmeans_iterations=10, device=dev)
    torch.cuda.synchronize()
    out["sog_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pc2 = read_sog(sog)
    out["sog_read_s"] = time.perf_counter() - t0
    order = np.argsort(morton_encode(pc.means))  # the writer's order
    s1 = np.sort(1 / (1 + np.exp(-pc.opacity.reshape(-1))))
    s2 = np.sort(1 / (1 + np.exp(-pc2.opacity.reshape(-1))))
    errs = {"means": float(np.abs(pc2.means - pc.means[order]).max()),
            "scaling": float(np.abs(np.sort(pc2.scaling.reshape(-1))
                                    - np.sort(pc.scaling.reshape(-1))).max()),
            "opacity": float(np.abs(s2 - s1).max()),
            "sh0": float(np.abs(pc2.sh0 - pc.sh0[order]).max())}
    if not (pc2.size == pc.size and errs["means"] <= 5e-3 and errs["scaling"] <= 0.1
            and errs["opacity"] <= 0.01):
        fail(f"live: SOG round trip of {pc.size} gaussians outside the bounds "
             f"(means 5e-3, scaling 0.1, opacity 0.01): {errs}")
    size_mb = sog.stat().st_size / 2**20
    say(f"[live] SOG: write_sog of {pc.size} gaussians SH3 (palette 65536 x 45, 10 k-means "
        f"iterations on the card, lossless WebP) {out['sog_write_s']:.2f} s, read_sog "
        f"{out['sog_read_s']:.2f} s, {size_mb:.1f} MiB; round trip max |diff| in the writer's "
        f"order: {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} (bounds: means 5e-3, "
        f"sorted scaling 0.1, sorted opacity 0.01) | {card}")

    def cli_png(spec: str, png: Path):
        png.unlink(missing_ok=True)
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["-v", spec, "--render-output", str(png), "--render-size", str(W),
                           str(H)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = {k: fn.launches - before[k] for k, fn in counters.items()}
        if rc != 0 or min(ran["expand_instances"], ran["blend_forward"]) < 1:
            fail(f"live: cli -v {spec}: rc {rc}, launches {ran}")
        img = png_array(png.read_bytes())
        if img.shape != (H, W, 3) or not img.std() > 1.0:
            fail(f"live: cli -v {spec}: PNG {img.shape} std {img.std():.3f}")
        return img, secs

    ref = png_array((WORK / "view.png").read_bytes())  # [main]'s frame of scene.ply
    img, secs = cli_png(str(sog), root / "sog.png")
    mse = float(np.mean((img.astype(np.float64) - ref.astype(np.float64)) ** 2))
    out["sog_psnr"] = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    say(f"[live] cli -v scene.sog --render-output sog.png --render-size {W} {H}: rc 0 in "
        f"{secs:.2f} s (read_sog, probe, P1, P2, PNG), std {img.std():.2f}; PSNR against "
        f"the PLY's frame {out['sog_psnr']:.2f} dB | {card}")

    # --- several models: the scene's PLY split in two ------------------------------
    half = pc.size // 2
    a_ply, b_ply = root / "a.ply", root / "b.ply"
    for path, sl in ((a_ply, slice(0, half)), (b_ply, slice(half, None))):
        write_ply(SplatData.from_arrays(*(v[sl] for v in arrays.values())).to_point_cloud(), path)
    img, secs = cli_png(f"{a_ply},{b_ply}", root / "two.png")
    d = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    med, within1 = float(np.median(d)), float((d <= 1).mean())
    if not (med == 0 and within1 >= 0.999):
        fail(f"live: -v a.ply,b.ply against the whole scene: median |diff| {med}, within 1 u8 "
             f"{within1}")
    say(f"[live] cli -v a.ply,b.ply (the scene split in two, concat_splats): rc 0 in "
        f"{secs:.2f} s; against the whole scene's frame median |diff| {med:.0f} u8, within 1 "
        f"u8 {100 * within1:.3f}% (gate: 0, >= 99.9%) | {card}")

    # --- the .html export ----------------------------------------------------------
    html = root / "scene.html"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["-v", str(WORK / "scene.ply"), "--render-output", str(html)])
    secs = time.perf_counter() - t0
    text = html.read_text() if html.exists() else ""
    found = re.search(r"const META = (\{.*?\});", text)
    meta = json.loads(found.group(1)) if found else {}
    n_data = len(re.search(r'atob\("([A-Za-z0-9+/=]*)"\)', text).group(1)) * 3 // 4 \
        if found else 0
    if rc != 0 or meta.get("count") != pc.size or abs(n_data - 37 * pc.size) > 2:
        fail(f"live: .html export rc {rc}, META count {meta.get('count')}, {n_data} data bytes")
    say(f"[live] cli -v scene.ply --render-output scene.html: rc 0 in {secs:.2f} s (host numpy), "
        f"{html.stat().st_size / 2**20:.1f} MiB, META count {meta['count']}, {n_data} data bytes "
        f"(37 per splat) read back")

    # --- CoherentRenderer at 1920x1080 ---------------------------------------------
    from lichtfeld_studio_tpu_torch.core.camera import look_at_camera

    def orbit_cam(t):
        return look_at_camera(8.0 * np.array([np.sin(t), -0.1, -np.cos(t)]), np.zeros(3),
                              np.array([0.0, -1.0, 0.0]), 1500.0, 1500.0, W, H)

    slow = [orbit_cam(t) for t in np.linspace(0.0, LIVE_ORBIT_SPAN, 60)]
    jump = orbit_cam(LIVE_JUMP)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        p0 = slow[0].device_params(dev)
        n_exact = int(count_instances(splats, p0, dilate_px=0.0))
        n_dil = int(count_instances(splats, p0, dilate_px=2.0))
        out["dilation_growth"] = n_dil / n_exact - 1.0
        # the drift bound of the last orbit frame against the first (the
        # renderer's own estimate, render/coherent.py::_drift_px, from the
        # nearest visible depth of the bin camera)
        r = coherent.CoherentRenderer(W, H, max_reuse=LIVE_MAX_REUSE)
        r.render(splats, slow[0], as_numpy=False)
        c = r._cache
        drift = r._drift_px(np.asarray(slow[-1].w2c, np.float64),
                            np.asarray(slow[-1].cam_position, np.float64), c["z_min"], 1500.0, 1500.0)
        if not drift < r.drift_budget:
            fail(f"live: the slow orbit drifts {drift:.3f} px >= the budget {r.drift_budget}")
        # 61 renders of the orbit (the one above and 60 more) re-bin every
        # max_reuse + 1 frames; the jump re-bins once
        predicted = -(-61 // (LIVE_MAX_REUSE + 1)) + 1
        _, cap = snug_cap(splats, [slow[0], slow[-1], jump])
        seen, real = [], coherent.blend_forward

        def spy(*args, **kw):
            res = real(*args, **kw)
            if not seen:
                seen.append((args, kw, res))
            return res

        worst = (0.0, 1.0)
        for k, cam in enumerate(slow + [jump]):
            coherent.blend_forward = spy if k == 1 else real  # a frame on a reused bin
            try:
                img = r.render(splats, cam, as_numpy=False)
            finally:
                coherent.blend_forward = real
            with uncounted(counters):
                ex, n_inst = render_frame_u8(splats, cam.device_params(dev), bg, "cuda", cap)
            if int(n_inst) > cap:
                fail(f"live: the exact frame {k} overflows its cap {cap}")
            med, within3 = u8_gate(img, ex)
            worst = (max(worst[0], med), min(worst[1], within3))
        if not (worst[0] <= 1 and worst[1] > 0.99):
            fail(f"live: a coherent frame against the exact frame: median {worst[0]}, within 3 u8 "
                 f"{worst[1]} (bounds: <= 1, > 0.99)")
        orbit_bins = r.stats["bins"]
        if orbit_bins != predicted:
            fail(f"live: {orbit_bins} bins over the orbit and the jump, predicted {predicted}")
        # P2 on the frame pass against its plain version
        args, kw, (img4, alpha) = seen[0]
        t0 = time.perf_counter()
        img_p, al_p = kblend.blend_forward_plain(*args, **kw)
        torch.cuda.synchronize()
        p2_plain_ms = 1e3 * (time.perf_counter() - t0)
        p2_err = max(float((img4 - img_p).abs().max()), float((alpha - al_p).abs().max()))
        if not p2_err <= P2_CHECK_TOL:
            fail(f"live: P2 on a coherent frame pass disagrees with its plain version: {p2_err}")
        del img_p, al_p
        with uncounted(counters):
            p2_ms = cuda_ms(lambda: kblend.blend_forward(*args, **kw))
        # an in-place write of the model re-bins
        bins = r.stats["bins"]
        splats.replace_trainable({"means": splats.means + 1e-3})
        r.render(splats, jump, as_numpy=False)
        rebinned = r.stats["bins"] - bins
        splats.replace_trainable({"means": splats.means - 1e-3})
        if rebinned != 1:
            fail(f"live: an in-place replace_trainable gave {rebinned} re-bins, not 1")
        # device time per frame under the profiler (busy union of the
        # device events): 10 coherent frames on a reused bin, 10 exact
        # frames of the same camera, 3 bin passes
        pj = jump.device_params(dev)
        r.render(splats, jump, as_numpy=False)  # the bin after the restore

        def device_per_call(fn, n):
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / n
            d = device_summary(prof, top=3)
            if d is None:
                return None
            return {"device_ms": d["busy_us"] / 1e3 / n, "events": d["events"] / n, "wall_ms": wall}

        with uncounted(counters):
            dev_c = device_per_call(lambda: r.render(splats, jump, as_numpy=False), 10)
            dev_e = device_per_call(lambda: render_frame_u8(splats, pj, bg, "cuda", cap), 10)
            dev_b = device_per_call(lambda: r._bin(splats, pj), 3)
        if r.stats["bins"] != bins + 2:  # the write's and the restore's
            fail(f"live: the profiled coherent frames re-binned: {r.stats}")
        # frames per second: the coherent orbit (a fresh renderer, warmed by
        # its first bin) and the exact orbit, the same 59 cameras
        with uncounted(counters):
            rt = coherent.CoherentRenderer(W, H, max_reuse=LIVE_MAX_REUSE)
            rt.render(splats, slow[0], as_numpy=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for cam in slow[1:]:
                rt.render(splats, cam, as_numpy=False)
            torch.cuda.synchronize()
            fps_c = 59 / (time.perf_counter() - t0)
            fps_e = benchmark_fps(splats, n_frames=59, instance_cap=cap, cameras=slow[1:])
            br = bench_render.benchmark_render(dev)
    out.update(p2_err=p2_err, p2_ms=p2_ms, p2_plain_ms=p2_plain_ms, coherent_fps=fps_c,
               exact_fps=fps_e, device={"coherent": dev_c, "exact": dev_e, "bin": dev_b},
               bins=r.stats["bins"], instances=r.stats["instances"], bench=br)
    say(f"[live] CoherentRenderer {W}x{H}, {pc.size} gaussians: dilate_px 2 grows view 0's "
        f"instances {n_exact} -> {n_dil} ({100 * out['dilation_growth']:.2f}%); slow orbit 60 "
        f"frames over {LIVE_ORBIT_SPAN} rad (drift of the last frame {drift:.3f} px < budget "
        f"{r.drift_budget}) then a {LIVE_JUMP} rad jump: {orbit_bins} bins, predicted "
        f"{predicted} (max_reuse {LIVE_MAX_REUSE}); every frame against the "
        f"exact frame: worst median {worst[0]:.0f} u8, worst share within 3 u8 "
        f"{100 * worst[1]:.3f}% (bounds <= 1, > 99%); an in-place write re-binned once | {card}")
    def dtext(d):
        return ("no device events in the trace" if d is None else
                f"{d['device_ms']:.3f} ms device busy, {d['events']:.0f} device events, wall "
                f"{d['wall_ms']:.3f} ms")

    say(f"[live] per call under the profiler (the jump's camera): coherent frame on a reused bin "
        f"{dtext(dev_c)}; exact frame {dtext(dev_e)}; bin pass {dtext(dev_b)} | {card}")
    say(f"[live] P2 on "
        f"a reused bin ({int(args[2].shape[0])} slots): kernel {p2_ms:.3f} ms, plain "
        f"{p2_plain_ms:.1f} ms (1 run), max |kernel - plain| {p2_err:.3g} <= {P2_CHECK_TOL}; "
        f"orbit of 59 frames: coherent {fps_c:.2f} FPS ({rt.stats['bins']} bins incl. the warm "
        f"one), exact {fps_e:.2f} FPS (benchmark_fps, cap {cap}) | {card}")
    for line in bench_render.json_lines(br):
        say(line)
    say(f"[live] bench_render: exact orbit {br['exact_fps']:.2f} FPS (peak {br['peak_instances']}, "
        f"cap {br['instance_cap']}), coherent drag {br['coherent_fps']:.2f} FPS "
        f"({br['coherent_bins']} bins / {br['coherent_frames']} frames) | {card}")

    # --- the live server around the trainer --------------------------------------
    live_out = root / "run"
    params = cli.parse_args_and_params(["-d", str(scene), "-o", str(live_out), *TRAINER_ARGS,
                                        "--iterations", "2000", "--save-state-every", "0",
                                        "--sog"])
    log = io.StringIO()
    notes = []
    with contextlib.redirect_stdout(log):
        trainer = Trainer.setup(params, dev)
        trainer.training_active = True  # before the server takes a request (as cli.py)
        server = LiveTrainingServer(trainer, port=0).start()
        trainer.control = server.control
        result = {}

        def run():
            try:
                result["stats"] = trainer.train()
            except Exception as e:  # reported by the main thread
                result["error"] = repr(e)

        th = threading.Thread(target=run, daemon=True)
        th.start()
        try:
            def wait_it(n, limit=300.0):
                t_end = time.time() + limit
                while trainer.last_progress[0] < n and th.is_alive() and time.time() < t_end:
                    time.sleep(0.05)
                return trainer.last_progress[0]

            def frame():
                code, body = http(server.port, f"/render.png?w={W}&h={H}")
                if code != 200:
                    fail(f"live: /render.png while training: {code} {body[:300]!r}")
                img = png_array(body)
                (rnd,) = server._coherent.values()
                return img, rnd.stats["bins"], json.loads(http(server.port, "/state.json")[1])

            it1 = wait_it(3)
            img1, bins1, st1 = frame()
            wait_it(it1 + 5)
            img2, bins2, st2 = frame()
            if not (img1.max() > 0 and img2.max() > 0 and bins2 > bins1
                    and st2["iteration"] > st1["iteration"] and st1["status"] == "training"):
                fail(f"live: renders while training: max {img1.max()}/{img2.max()}, bins "
                     f"{bins1} -> {bins2}, state {st1} -> {st2}")
            notes.append(f"renders at iterations {st1['iteration']} and {st2['iteration']}: "
                         f"bins {bins1} -> {bins2}, frames non-black")
            # the pause takes at the end of the dispatch in flight (and of
            # its scheduled eval and save): TrainingPaused says where
            paused_at = []
            h = events.bus().when(events.TrainingPaused, lambda e: paused_at.append(e.iteration))
            try:
                http(server.port, "/control?cmd=pause", {})
                t_end = time.time() + 300
                while not paused_at and time.time() < t_end:
                    time.sleep(0.05)
            finally:
                events.bus().off(events.TrainingPaused, h)
            if not paused_at:
                fail("live: pause: the trainer never reached its pause gate")
            frozen = json.loads(http(server.port, "/state.json")[1])
            time.sleep(2.0)
            later = json.loads(http(server.port, "/state.json")[1])
            if not (frozen["status"] == "paused"
                    and later["iteration"] == frozen["iteration"] == paused_at[0]):
                fail(f"live: pause at {paused_at[0]}: {frozen} -> {later}")
            img3, _, _ = frame()  # renders while paused, on the trainer's thread
            # the save is taken in the pause loop, at the paused iteration
            saved_at = []
            h = events.bus().when(events.CheckpointSaved,
                                  lambda e: saved_at.append((e.iteration, e.path)))
            try:
                http(server.port, "/control?cmd=save", {})
                t_end = time.time() + 120
                while not saved_at and time.time() < t_end:
                    time.sleep(0.05)
            finally:
                events.bus().off(events.CheckpointSaved, h)
            ply = live_out / f"splat_{paused_at[0]}.ply"
            if not (saved_at and saved_at[0] == (paused_at[0], str(ply)) and ply.exists()):
                fail(f"live: save while paused at {paused_at[0]}: {saved_at}")
            notes.append(f"paused at {frozen['iteration']} (no advance over 2 s, a frame "
                         f"rendered), the save request wrote {ply.name} in the pause")
            http(server.port, "/control?cmd=resume", {})
            wait_it(frozen["iteration"] + 2)
            http(server.port, "/control?cmd=stop", {})
            th.join(timeout=600)
        finally:
            trainer.control.request_stop()
            th.join(timeout=600)
            server.stop()
    text = log.getvalue()
    if th.is_alive() or "error" in result:
        fail(f"live: the viewed trainer did not end cleanly: {result.get('error')}")
    last = trainer.last_progress[0]
    sogs = sorted(p.name for p in live_out.glob("splat_*.sog"))
    if not (last < 2000 and (live_out / "viewer_live.html").exists() and sogs
            and "[viewer] live export failed" not in text):
        fail(f"live: stopped at {last}, viewer_live.html "
             f"{(live_out / 'viewer_live.html').exists()}, SOGs {sogs}, export failure line "
             f"{'[viewer] live export failed' in text}")
    for note in notes:
        say(f"[live] trainer under the live server: {note}")
    say(f"[live] trainer under the live server: resumed, stopped at iteration {last} of 2000 "
        f"(train() ran {result['stats']['elapsed_s']:.1f} s, pauses, saves and renders "
        f"included); "
        f"output holds viewer_live.html and {sogs}; no live export failure | {card}")

    # --- the studio session ----------------------------------------------------------
    with contextlib.redirect_stdout(log):
        session = StudioSession(out_dir=root / "studio", device=dev)
        server = LiveTrainingServer(session, port=0).start()
        try:
            def post(path, body):
                code, raw = http(server.port, path, body)
                if code != 200:
                    fail(f"live: studio {path} {body}: {code} {raw[:300]!r}")
                return json.loads(raw)

            opened = post("/open", {"path": str(sog)})
            code, body = http(server.port, f"/render.png?w={W}&h={H}")
            if code != 200 or not png_array(body).max() > 0:
                fail(f"live: studio render of the .sog: {code}")
            crop = post("/crop", {"min": [-3, -3, -3], "max": [0, 3, 3]})
            post("/transform", {"translate": [0.5, 0, 0], "euler": [0, 0.3, 0]})
            saved = post("/saveply", {"name": "edited"})
            if not (opened["num_gaussians"] == pc.size and 0 < crop["kept"] < pc.size
                    and Path(saved["path"]).exists()):
                fail(f"live: studio edits: {opened}, {crop}, {saved}")
            staged = post("/open", {"path": str(scene)})
            t0 = time.perf_counter()
            post("/train", {"argv": LIVE_STUDIO_ARGS})
            if not session.wait(timeout=600):
                fail("live: the studio run did not finish in 600 s")
            train_s = time.perf_counter() - t0
            sj = json.loads(http(server.port, "/session.json")[1])
            if not (sj["mode"] == "done" and sj["train_error"] is None):
                fail(f"live: studio session after the run: {sj}")
            n_trained = int(session.splats.n_active)
            crop2 = post("/crop", {"min": [-2, -9, -9], "max": [9, 9, 9]})
            if crop2["kept"] + crop2["removed"] != n_trained or not crop2["kept"]:
                fail(f"live: crop of the trained model: {crop2}, {n_trained} trained")
        finally:
            if session.control is not None:
                session.control.request_stop()
            session.wait(timeout=600)
            server.stop()
    say(f"[live] studio: /open scene.sog ({opened['num_gaussians']} gaussians), /render.png "
        f"{W}x{H}, /crop kept {crop['kept']}, /transform, /saveply; /open the [trainer] dataset "
        f"({staged['num_cameras']} cameras), /train {' '.join(LIVE_STUDIO_ARGS)} in "
        f"{train_s:.1f} s (setup included), /session.json mode done, train_error null; crop of "
        f"the trained model kept {crop2['kept']} of {n_trained} | {card}")
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    if min(out["launches"].values()) < 1:
        fail(f"live: a kernel of the path was not launched: {out['launches']}")
    say(f"[live] launches on the live path: {out['launches']}")
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
        cap_p1 = max(1 << 21, -(-int(nt.sum()) // 1024) * 1024)
        p1 = check_p1("render, 1080p view 0", nt, payload, cap_p1, card)
        # and at the train step's shape: bench.py's scene, 1M capacity, cap 1.4M
        from lichtfeld_studio_tpu_torch import bench_train

        sd_b, cam_b, _, _, cfg_b, _ = bench_train.bench_setup(dev)
        proj_b = _project(sd_b, cam_b, tile_size=cfg_b.tile_size)
        p1_train = check_p1("train step, bench.py's scene", proj_b.n_touched,
                            pack_payload(proj_b), cfg_b.instance_cap, card)
        del sd_b, proj_b, proj0, nt, payload

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
        p2_skip = kblend.blend_forward_skip_stats(*args, **kw)  # the counting instance
        if p2_skip["lost"] != 0:
            fail(f"P2 at {W}x{H}: the reach skip dropped pairs that pass the alpha test: {p2_skip}")
        p2_pairs = blend_work(blend_groups(args, kw), kw["tile_size"],
                              kblend.INFERENCE_TERM_THRESHOLD)
        check_mirror("P2", f"{W}x{H}", p2_pairs)
        p2_bound = bound(nbytes(*args, img4, alpha), blend_ops("P2", p2_pairs, "forward"))
        if not (torch.isfinite(img4).all() and big_err <= P2_CHECK_TOL):
            fail(f"P2 disagrees with its plain version at {W}x{H}: max |diff| {big_err} "
                 f"> {P2_CHECK_TOL}")
    say(f"[main] orbit 8 views {W}x{H}, {N_BENCH} gaussians SH3: peak {peak} instances, cap "
        f"{cap}, median {fps:.2f} FPS of 5 runs of 20 frames "
        f"({', '.join(f'{f:.2f}' for f in fps_runs)}; benchmark_fps: device path, u8 on "
        f"device) | {card}")
    say("[main] view 0 stage ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + f"; P2 plain version {p2_plain_ms:.1f} ms (1 run), max |kernel - plain| at {W}x{H} "
        f"{big_err:.3g} <= {P2_CHECK_TOL}; P2 reach skip {p2_skip['skipped']} of "
        f"{p2_skip['warp_pairs']} (warp, instance) pairs walked "
        f"({100 * p2_skip['skipped'] / max(p2_skip['warp_pairs'], 1):.1f}%), {p2_skip['lost']} "
        f"lost | {card}")

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
            kern, err, p2t_plain_ms, p2t_ms, p2t_skip = check_p2_train(
                f"{label} {ts}-px tiles", a, args, kw, card)
            p2t_err = max(p2t_err, err)

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
            if not torch.equal(rows, kblend.blend_backward(*bwd, **kw)):
                fail(f"P3 at {label}, {ts}-px tiles: two launches on equal inputs differ")
            p3_rel = max(p3_rel, rel)
            p3_ms = cuda_ms(lambda: kblend.blend_backward(*bwd, **kw))
            if sd is sd_b:  # the bounds at the train path's size
                p3_pairs = blend_work(blend_groups(args, kw), ts)
                check_mirror("P2-train", label, p3_pairs)
                if p3_pairs["backward_walked"] != int((last.long() + 1).sum()):
                    fail(f"P3 at {label}: the plain walk ends disagree with P2's last indices")
                p2t_bound = bound(nbytes(*args, *kern), blend_ops("P2", p3_pairs, "forward"))
                p3_bound = bound(nbytes(*bwd, rows), blend_ops("P3", p3_pairs, "backward"))
                p3_skip = kblend.blend_backward_skip_stats(*bwd, **kw)  # the counting instance
                p2t_fresh = {"skip": p2t_skip, "instances": int(a.n_instances)}
            say(f"[P3] {label} {ts}-px tiles: P3 -> P4 against the plain backward (autograd "
                f"through the dense blend, float64 segment sums), per group max |diff| "
                f"{rel:.3g} of the largest gradient <= {P3_CHECK_REL}, two launches bit-equal; P3 "
                f"kernel {p3_ms:.3f} ms, plain backward + P4 {p3_plain_ms:.1f} ms (1 run) | {card}")
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
        p4_cases_rel = check_p4_cases(dev)
        say(f"[P4] {len(segment_cases())} adversarial layouts ({', '.join(segment_cases())}) x "
            f"{len(SEGMENT_COLUMNS)} widths {SEGMENT_COLUMNS} x (as is, repeated 40 times): max "
            f"|kernel - plain| {p4_cases_rel:.3g} of the largest sum <= {P4_CHECK_REL}, two "
            f"launches bit-equal | {card}")
        say(f"[P3] reach skip at {checks[-1][0]} (the kernel's counting instance, not timed): of "
            f"{p3_skip['warp_pairs']} (warp, instance) pairs walked, {p3_skip['skipped']} "
            f"({100 * p3_skip['skipped'] / max(p3_skip['warp_pairs'], 1):.1f}%) skipped by the "
            f"reach box, {p3_skip['reduced']} ended in a warp reduction | {card}")
        say(f"[P3] bounds at {checks[-1][0]}: P2-train {p2t_bound[0]:.4f} ms ({p2t_bound[1]}), P3 "
            f"{p3_bound[0]:.4f} ms ({p3_bound[1]}); pairs: {pair_summary(p3_pairs)}; P2 at "
            f"{W}x{H} (inference stop) {p2_bound[0]:.4f} ms ({p2_bound[1]}), pairs: "
            f"{pair_summary(p2_pairs)} | {card}")
        del sd_b, checks, proj, a, rows, kern, g_p, g_k, s4_p, s4_k, bwd

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
    # P2-train and P3 on the binning of the model the steps left (after refines)
    with torch.no_grad():
        proj = _project(state.splats, cam_t, tile_size=cfg_t.tile_size)
        kw = dict(grid_w=-(-cam_t.width // cfg_t.tile_size),
                  grid_h=-(-cam_t.height // cfg_t.tile_size), tile_size=cfg_t.tile_size)
        a = build_tile_assignment(proj, grid_w=kw["grid_w"], grid_h=kw["grid_h"],
                                  instance_cap=cfg_t.instance_cap)
        args = (a.tile_start, a.tile_count, a.gaussian_idx, proj.mean2d, proj.conic,
                proj.opacity, proj.color)
        kern, err, _, p2t_trained_ms, p2t_trained_skip, p2t_trained_pairs = check_p2_train(
            f"the trained model's binning ({int(state.splats.n_active)} live, after "
            f"{r['steps']} steps)", a, args, kw, card, with_pairs=True)
        p2t_err = max(p2t_err, err)
        gen = torch.Generator(device=dev).manual_seed(kw["tile_size"])
        bwd = (*args[:3], a.slot_layout, *args[3:], kern[2], kern[3],
               torch.randn(kern[0].shape, generator=gen, device=dev),
               torch.randn(kern[1].shape, generator=gen, device=dev))
        p3_trained_ms = cuda_ms(lambda: kblend.blend_backward(*bwd, **kw))
        p2t_trained = {"ms": p2t_trained_ms, "skip": p2t_trained_skip,
                       "instances": int(a.n_instances), "p3_ms": p3_trained_ms,
                       "pairs": p2t_trained_pairs,
                       "bound": bound(nbytes(*args, *kern), blend_ops("P2", p2t_trained_pairs,
                                                                      "forward")),
                       "p3_bound": bound(nbytes(*bwd) + 4 * bwd[3].numel() * (6 + bwd[7].shape[1]),
                                         blend_ops("P3", p2t_trained_pairs, "backward"))}
        say(f"[P3] the trained model's binning: P3 kernel {p3_trained_ms:.3f} ms, bound "
            f"{p2t_trained['p3_bound'][0]:.4f} ms ({p2t_trained['p3_bound'][1]}); P2-train bound "
            f"{p2t_trained['bound'][0]:.4f} ms ({p2t_trained['bound'][1]}) | {card}")
        del proj, a, args, kern, bwd
    del state
    bench_plain_ms, bench_it_s = r["plain_ms"], r["it_s"]

    # --- 8. the world-blend kernels against their plain versions -------------
    import dataclasses

    from lichtfeld_studio_tpu_torch import bench_gut
    from lichtfeld_studio_tpu_torch.core.camera import CameraModelType, ShutterType
    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb
    from lichtfeld_studio_tpu_torch.ops.rasterize import capture_world_inputs

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
        _, err_f, plain_f_ms, big["p5_frame_skip"] = check_p5(
            f"{label_g}, the forward frame's binning", fwd_f, kw_f, need_skip=True)
        big["p5_frame_ms"] = cuda_ms(lambda: kwb.world_blend_forward(*fwd_f, **kw_f))
        world = {k: max(world[k], big[k]) for k in world}
        world["p5_err"] = max(world["p5_err"], err_f)
        say(f"[P5] {label_g}, the forward frame's inputs (inference binning, "
            f"{int(fwd_f[4].sum())} instances): max |kernel - plain| {err_f:.3g} <= "
            f"{P5_CHECK_TOL}, last counted index equal, two launches bit-equal; "
            f"{skip_text(big['p5_frame_skip'])}; kernel {big['p5_frame_ms']:.3f} ms, "
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
    # P5 and P6 -> P4 on the binning of the model the steps left (after refines)
    with torch.no_grad():
        inputs = capture_world_inputs(state.splats, cam_t, tile_size=cfg_t.tile_size,
                                      instance_cap=cfg_t.instance_cap)
        trained = check_world_kernels(
            f"the trained model's binning ({int(state.splats.n_active)} live, after "
            f"{r['steps']} steps), fisheye", *inputs, card, time_them=True)
        world["p6_rel"] = max(world["p6_rel"], trained["p6_rel"])
        world["p5_err"] = max(world["p5_err"], trained["p5_err"])
        del inputs

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

    # --- 13. main path: the trainer with the four training components ---------
    comp_r = components_phase(dev, card, counters, WORK / "trainer" / "scene", trainer_r["it_s"])
    torch.cuda.empty_cache()

    # --- 14. the exact path's ORTHO and pose-gradient cases -------------------
    exact_cases_phase(dev, card)
    torch.cuda.empty_cache()

    # --- 15. the self-check's protocol: MCMC, then ADC ------------------------
    selfcheck_phase(dev, card)
    torch.cuda.empty_cache()

    # --- 16. main path: the live viewer (SOG, -v, .html, coherent, server, studio)
    live_r = live_phase(dev, card, splats, counters, WORK / "trainer" / "scene")
    ll = live_r["launches"]

    tl, cl = trainer_r["launches"], comp_r["launches"]
    by_path = {
        "expand_instances": {"render": launches["expand_instances"],
                             "train": train_launches["expand_instances"],
                             "gut": gut_launches["expand_instances"],
                             "trainer": tl["expand_instances"],
                             "components": cl["expand_instances"], "live": ll["expand_instances"]},
        "blend_forward": {"render": launches["blend_forward"],
                          "train": train_launches["blend_forward"],
                          "trainer": tl["blend_forward"], "components": cl["blend_forward"],
                          "live": ll["blend_forward"]},
        "blend_backward": {"train": train_launches["blend_backward"],
                           "trainer": tl["blend_backward"], "components": cl["blend_backward"],
                           "live": ll["blend_backward"]},
        "segment_reduce": {"train": train_launches["segment_reduce"],
                           "gut": gut_launches["segment_reduce"],
                           "trainer": tl["segment_reduce"], "components": cl["segment_reduce"],
                           "live": ll["segment_reduce"]},
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
        entry("expand_instances", "expand.cu", "expand_pallas.py:67", float(p1["err"]),
              p1["kernel_ms"], p1["plain_ms"], p1["bound"], p1["library_ms"],
              library_is="torch.searchsorted(ends, slots, right=True) on the same ends and "
                         "slots: the owner only (the rank and the payload are two more "
                         "gathers); ms is the C entry's on the same ends, wrapper_ms the "
                         "wrapper's (the cumsum and the kernel, host-bound back to back)",
              wrapper_ms=p1["ms"], max_abs_err_train=float(p1_train["err"]),
              ms_train=p1_train["kernel_ms"], wrapper_ms_train=p1_train["ms"],
              plain_ms_train=p1_train["plain_ms"], bound_ms_train=p1_train["bound"][0],
              library_ms_train=p1_train["library_ms"],
              shape=f"render: {p1['n'][0]} gaussians, 1080p view 0, cap {p1['n'][2]} (train: "
                    f"{p1_train['n'][0]} gaussians of bench.py's scene, cap {p1_train['n'][2]})"),
        entry("blend_forward", "blend_forward.cu", "blend_pallas.py:293",
              max(p2_err, big_err, p2t_err, live_r["p2_err"]), p2_ms, p2_plain_ms, p2_bound,
              max_abs_err_coherent_frame=live_r["p2_err"], ms_coherent_frame=live_r["p2_ms"],
              plain_ms_coherent_frame=live_r["p2_plain_ms"],
              max_abs_err_inference=max(p2_err, big_err), max_abs_err_train=p2t_err,
              ms_train=p2t_big_ms, plain_ms_train=p2t_big_plain_ms, bound_ms_train=p2t_bound[0],
              pairs=p2_pairs, pairs_train=p3_pairs,
              reach_skip=p2_skip, reach_skip_train=p2t_fresh["skip"],
              ms_train_trained=p2t_trained["ms"], reach_skip_train_trained=p2t_trained["skip"],
              pairs_train_trained=p2t_trained["pairs"],
              bound_ms_train_trained=p2t_trained["bound"][0],
              instances_train_trained=p2t_trained["instances"],
              shape="render 1080p view 0 (train: 1296x840 bench scene; trained: the train "
                    "phase's model after its steps)"),
        entry("blend_backward", "blend_backward.cu", "blend_pallas.py:514", p3_rel, p3_big_ms,
              p3_big_plain_ms, p3_bound,
              max_err_is="relative to the largest plain gradient of each group", pairs=p3_pairs,
              reach_skip=p3_skip, ms_trained=p2t_trained["p3_ms"],
              bound_ms_trained=p2t_trained["p3_bound"][0],
              shape="1296x840 bench scene, 32-px tiles"),
        entry("segment_reduce", "segment_reduce.cu", "segment_reduce.py:72", p4_rel, p4_ms,
              p4_plain_ms, p4_bound, p4_lib_ms, max_err_is="relative to the largest plain sum",
              shape=f"P3's rows of the 1296x840 bench scene, {n_seg} gaussians",
              ms_gut=big["p4_ms"], plain_ms_gut=big["p4_plain_ms"],
              bound_ms_gut=big["p4_bound"][0], library_ms_gut=big["p4_lib_ms"],
              max_err_adversarial_layouts=p4_cases_rel),
        entry("world_blend_forward", "world_blend_forward.cu", "world_blend_pallas.py:330",
              world["p5_err"], big["p5_ms"], big["p5_plain_ms"], big["p5_bound"],
              ms_forward_frame=big["p5_frame_ms"], pairs=big["pairs"],
              ray_skip=big["p5_skip"], ray_skip_forward_frame=big["p5_frame_skip"],
              ray_skip_trained=trained["p5_skip"], pairs_trained=trained["pairs"],
              ms_trained=trained["p5_ms"], bound_ms_trained=trained["p5_bound"][0],
              shape="1296x840 fisheye bench_gut scene, 32-px tiles, training binning"),
        entry("world_blend_backward", "world_blend_backward.cu", "world_blend_pallas.py:431",
              world["p6_rel"], big["p6_ms"], big["p6_plain_ms"], big["p6_bound"],
              max_err_is="P6 -> P4, relative to the largest plain gradient of each group",
              pairs=big["pairs"], ray_skip=big["p6_skip"], ms_trained=trained["p6_ms"],
              plain_ms_trained=trained["p6_plain_ms"], bound_ms_trained=trained["p6_bound"][0],
              pairs_trained=trained["pairs"], ray_skip_trained=trained["p6_skip"],
              instances_trained=trained["n_instances"],
              shape="1296x840 fisheye bench_gut scene, 32-px tiles (trained: the gut phase's "
                    "model after its steps)"),
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
