"""A/B of two checkouts of the port on one NVIDIA GPU: the tile blends P2
(training and inference), P3 and P6, the segment reduce P4, and what the
port's users feel (bench_train's and bench_gut's it/s, the orbit FPS), one
checkout a process. Numbers move between machines and between calls, so
compare two commits by running this file on both in turns, in one go on
one card:

    git archive <parent> | tar -x -C build/parent
    for root in build/parent . . build/parent; do
        python lichtfeld_studio_tpu_torch/tools/ab_kernels.py --root $root
    done

Run by path, not with -m: `--root` decides which checkout's package is
imported, and only what both must have is used (the wrappers, bench_train,
bench_gut, rasterize and ops.rasterize.capture_world_inputs,
render.headless).
The first line is the card's name and power limit, the last one JSON
object. The kernels run at chip_smoke.py's shapes: P2 inference on the
render scene at 1080p (view 0), P2 training, P3 and P4 on bench_train's
scene, P6 on bench_gut's fisheye scene; P2 training, P3 and P6 again on
the binning of the models that bench_train's and bench_gut's runs leave
after their steps and refines ("trained"). P4 is timed on P3's rows (9
columns) and on random rows of 24 columns with the same offsets (the width
of the world blend's rows), beside torch.segment_reduce on the same rows.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def blend_inputs(splats, params, *, tile_size, instance_cap, train=True):
    """`splats` binned through `params` as the steps (train) or the render
    bin them: (the tile assignment, blend_backward's arguments with seeded
    random cotangents, its keywords); for inference, blend_forward's
    arguments in place of blend_backward's."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import blend as kblend
    from lichtfeld_studio_tpu_torch.ops.rasterize import _project
    from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment

    with torch.no_grad():
        proj = _project(splats, params, tile_size=tile_size)
        kw = dict(grid_w=-(-params.width // tile_size), grid_h=-(-params.height // tile_size),
                  tile_size=tile_size)
        a = build_tile_assignment(proj, grid_w=kw["grid_w"], grid_h=kw["grid_h"],
                                  instance_cap=instance_cap, need_grad=train)
        args = (a.tile_start, a.tile_count, a.gaussian_idx, proj.mean2d, proj.conic,
                proj.opacity, proj.color)
        if not train:
            return a, args, kw
        _, _, t_final, last = kblend.blend_forward(*args, **kw, train=True)
        gen = torch.Generator(device=proj.mean2d.device).manual_seed(tile_size)
        d_image = torch.randn(t_final.shape + (3,), generator=gen, device=t_final.device)
        d_alpha = torch.randn(t_final.shape, generator=gen, device=t_final.device)
    bwd = (a.tile_start, a.tile_count, a.gaussian_idx, a.slot_layout, *args[3:],
           t_final, last, d_image, d_alpha)
    return a, bwd, kw


def bench_kernel_inputs(dev):
    """bench_train's scene binned as its step bins it (blend_inputs)."""
    from lichtfeld_studio_tpu_torch import bench_train

    sd, cam, _, _, cfg, _ = bench_train.bench_setup(dev)
    return blend_inputs(sd, cam, tile_size=cfg.tile_size, instance_cap=cfg.instance_cap)


def render_kernel_inputs(dev):
    """The render scene's view 0 at 1080p binned as the render bins it at
    the probe-snug cap: (assignment, blend_forward's arguments, keywords)."""
    import torch

    from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
    from lichtfeld_studio_tpu_torch.render.bench_scene import bench_arrays, bench_cameras
    from lichtfeld_studio_tpu_torch.render.headless import snug_cap

    with torch.no_grad():
        splats = SplatData.from_arrays(*bench_arrays().values(), scene_scale=3.0, device=dev)
        cams = bench_cameras()
        _, cap = snug_cap(splats, cams)
        return blend_inputs(splats, cams[0].device_params(dev), tile_size=32, instance_cap=cap,
                            train=False)


def world_kernel_inputs(splats, params, *, tile_size, instance_cap):
    """The gut-exact training path's world-blend inputs for `splats`
    through `params`: (assignment, world_blend_backward's arguments with
    seeded random cotangents, its grid keywords)."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb
    from lichtfeld_studio_tpu_torch.ops.rasterize import capture_world_inputs

    stream, rays_d, tau, a, kw = capture_world_inputs(splats, params, tile_size=tile_size,
                                                      instance_cap=instance_cap)
    grid = {k: kw[k] for k in ("grid_w", "grid_h", "tile_size")}
    with torch.no_grad():
        fwd = (stream, rays_d, tau, a.tile_start, a.tile_count, a.gaussian_idx)
        image, _, t_final, last = kwb.world_blend_forward(*fwd, **kw)
        gen = torch.Generator(device=stream.device).manual_seed(tile_size)
        d_image = torch.randn(image.shape, generator=gen, device=stream.device)
        d_alpha = torch.randn(t_final.shape, generator=gen, device=stream.device)
    return a, (*fwd, a.slot_layout, t_final, last, d_image, d_alpha), grid


def gut_kernel_inputs(dev):
    """bench_gut's fisheye scene (world_kernel_inputs)."""
    from lichtfeld_studio_tpu_torch import bench_gut

    sd, cam, _, _, cfg, _ = bench_gut.bench_setup(dev)
    return world_kernel_inputs(sd, cam, tile_size=cfg.tile_size, instance_cap=cfg.instance_cap)


def kernel_times(dev) -> dict:
    """P2 (both variants), P3, P4 and P6 at chip_smoke.py's shapes on the
    fresh scenes: device ms of the wrappers."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import blend as kblend
    from lichtfeld_studio_tpu_torch.kernels import segment_reduce as kseg
    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb
    from lichtfeld_studio_tpu_torch.profiling import device_ms

    out = {}
    with torch.no_grad():
        a, fwd, kw = render_kernel_inputs(dev)
        out["p2_inference_instances"] = int(a.n_instances)
        out["p2_inference_ms"] = device_ms(lambda: kblend.blend_forward(*fwd, **kw))
        del a, fwd
        a, bwd, kw = bench_kernel_inputs(dev)
        fwd = bwd[:3] + bwd[4:8]
        gen = torch.Generator(device=dev).manual_seed(kw["tile_size"])
        rows = kblend.blend_backward(*bwd, **kw)
        rows24 = torch.randn((rows.shape[0], 24), generator=gen, device=dev)
        off, used = a.segment_off, int(a.segment_off[-1])
        out.update({"instances": int(a.n_instances),
                    "p2_train_ms": device_ms(lambda: kblend.blend_forward(*fwd, **kw, train=True)),
                    "p3_ms": device_ms(lambda: kblend.blend_backward(*bwd, **kw))})
        for name, r in (("9", rows), ("24", rows24)):
            got, want = kseg.segment_reduce(r, off), kseg.segment_reduce_plain(r, off)
            out[f"p4_{name}_rel_err"] = float((got - want).abs().max() / want.abs().max())
            out[f"p4_{name}_ms"] = device_ms(lambda: kseg.segment_reduce(r, off))
            out[f"torch_segment_reduce_{name}_ms"] = device_ms(
                lambda: torch.segment_reduce(r[:used], "sum", offsets=off.long()))
        del a, bwd, fwd, rows, rows24
        a, wbwd, grid = gut_kernel_inputs(dev)
        out["p6_instances"] = int(a.n_instances)
        out["p6_ms"] = device_ms(lambda: kwb.world_blend_backward(*wbwd, **grid))
    return out


def trained_kernel_times(dev, train_r: dict, gut_r: dict) -> dict:
    """P2 training, P3 and P6 on the binning of the models that bench_train's
    and bench_gut's runs left (their states and cameras)."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import blend as kblend
    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb
    from lichtfeld_studio_tpu_torch.profiling import device_ms

    out = {}
    with torch.no_grad():
        cam, _, _, cfg = train_r["inputs"]
        a, bwd, kw = blend_inputs(train_r["state"].splats, cam, tile_size=cfg.tile_size,
                                  instance_cap=cfg.instance_cap)
        fwd = bwd[:3] + bwd[4:8]
        out["trained_instances"] = int(a.n_instances)
        out["p2_train_trained_ms"] = device_ms(lambda: kblend.blend_forward(*fwd, **kw, train=True))
        out["p3_trained_ms"] = device_ms(lambda: kblend.blend_backward(*bwd, **kw))
        del a, bwd, fwd
        cam, _, _, cfg = gut_r["inputs"]
        a, wbwd, grid = world_kernel_inputs(gut_r["state"].splats, cam, tile_size=cfg.tile_size,
                                            instance_cap=cfg.instance_cap)
        out["p6_trained_instances"] = int(a.n_instances)
        out["p6_trained_ms"] = device_ms(lambda: kwb.world_blend_backward(*wbwd, **grid))
    return out


def path_rates(dev) -> tuple[dict, dict, dict]:
    """bench_train's and bench_gut's it/s and the orbit FPS, as
    chip_smoke.py drives them; also the two runs' results (their states)."""
    import torch

    from lichtfeld_studio_tpu_torch import bench_gut, bench_train
    from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
    from lichtfeld_studio_tpu_torch.render.bench_scene import bench_arrays, bench_cameras
    from lichtfeld_studio_tpu_torch.render.headless import benchmark_fps, snug_cap

    steps = dict(warmup=1, dispatches=3, refine_warm=1, refine_timed=2)
    train = bench_train.benchmark_train(dev, **steps)
    gut = bench_gut.benchmark_gut(dev, frames=5, k_scan=10, **steps)
    out = {"train_it_s": train["it_s"], "train_plain_ms": train["plain_ms"],
           "gut_it_s": gut["it_s"], "gut_plain_ms": gut["plain_ms"],
           "gut_forward_fps": gut["forward_fps"]}
    with torch.no_grad():
        splats = SplatData.from_arrays(*bench_arrays().values(), scene_scale=3.0, device=dev)
        cams = bench_cameras()
        _, cap = snug_cap(splats, cams)
        fps = sorted(benchmark_fps(splats, n_frames=20, instance_cap=cap, cameras=cams)
                     for _ in range(5))
    out["orbit_fps_median_of_5"] = fps[2]
    return out, train, gut


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose package is measured (default: this one)")
    ns = ap.parse_args(argv)
    sys.path.insert(0, str(Path(ns.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels needs an NVIDIA GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    from lichtfeld_studio_tpu_torch import bench_train

    card = bench_train.card()
    print(card, flush=True)
    dev = torch.device("cuda")
    fresh = kernel_times(dev)
    torch.cuda.empty_cache()
    rates, train, gut = path_rates(dev)
    trained = trained_kernel_times(dev, train, gut)
    print(json.dumps({"root": ns.root, "card": card, **fresh, **trained, **rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
