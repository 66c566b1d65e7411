"""A/B of two checkouts of the port on one NVIDIA GPU: the blend backward
(P3) and the segment reduce (P4) at bench.py's shape, and what the port's
users feel (bench_train's and bench_gut's it/s, the orbit FPS), one
checkout a process. Numbers move between machines and between calls, so
compare two commits by running this file on both in turns, in one go on
one card:

    git archive <parent> | tar -x -C build/parent
    for root in build/parent . . build/parent; do
        python lichtfeld_studio_tpu_torch/tools/ab_kernels.py --root $root
    done

Run by path, not with -m: `--root` decides which checkout's package is
imported, and only what both have had since the train step was ported is
used (the wrappers, bench_train, bench_gut, render.headless). The first
line is the card's name and power limit, the last one JSON object. P4 is
timed on P3's rows (9 columns) and on random rows of 24 columns with the
same offsets (the width of the world blend's rows), beside
torch.segment_reduce on the same rows.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def bench_kernel_inputs(dev):
    """bench_train's scene binned as its step bins it: (the tile assignment,
    blend_backward's arguments with seeded random cotangents, its keywords)."""
    import torch

    from lichtfeld_studio_tpu_torch import bench_train
    from lichtfeld_studio_tpu_torch.kernels import blend as kblend
    from lichtfeld_studio_tpu_torch.ops.rasterize import _project
    from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment

    with torch.no_grad():
        sd, cam, _, _, cfg, _ = bench_train.bench_setup(dev)
        ts = cfg.tile_size
        proj = _project(sd, cam, tile_size=ts)
        kw = dict(grid_w=-(-cam.width // ts), grid_h=-(-cam.height // ts), tile_size=ts)
        a = build_tile_assignment(proj, grid_w=kw["grid_w"], grid_h=kw["grid_h"],
                                  instance_cap=cfg.instance_cap)
        args = (a.tile_start, a.tile_count, a.gaussian_idx, proj.mean2d, proj.conic,
                proj.opacity, proj.color)
        _, _, t_final, last = kblend.blend_forward(*args, **kw, train=True)
        gen = torch.Generator(device=dev).manual_seed(ts)
        d_image = torch.randn(t_final.shape + (3,), generator=gen, device=dev)
        d_alpha = torch.randn(t_final.shape, generator=gen, device=dev)
    bwd = (a.tile_start, a.tile_count, a.gaussian_idx, a.slot_layout, *args[3:],
           t_final, last, d_image, d_alpha)
    return a, bwd, kw


def kernel_times(dev) -> dict:
    """P3 and P4 at bench_train's shape: device ms of the wrappers."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import blend as kblend
    from lichtfeld_studio_tpu_torch.kernels import segment_reduce as kseg
    from lichtfeld_studio_tpu_torch.profiling import device_ms

    a, bwd, kw = bench_kernel_inputs(dev)
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(kw["tile_size"])
        rows = kblend.blend_backward(*bwd, **kw)
        rows24 = torch.randn((rows.shape[0], 24), generator=gen, device=dev)
        off, used = a.segment_off, int(a.segment_off[-1])
        out = {"instances": int(a.n_instances),
               "p3_ms": device_ms(lambda: kblend.blend_backward(*bwd, **kw))}
        for name, r in (("9", rows), ("24", rows24)):
            got, want = kseg.segment_reduce(r, off), kseg.segment_reduce_plain(r, off)
            out[f"p4_{name}_rel_err"] = float((got - want).abs().max() / want.abs().max())
            out[f"p4_{name}_ms"] = device_ms(lambda: kseg.segment_reduce(r, off))
            out[f"torch_segment_reduce_{name}_ms"] = device_ms(
                lambda: torch.segment_reduce(r[:used], "sum", offsets=off.long()))
    return out


def path_rates(dev) -> dict:
    """bench_train's and bench_gut's it/s and the orbit FPS, as
    chip_smoke.py drives them."""
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
    del train, gut
    torch.cuda.empty_cache()
    with torch.no_grad():
        splats = SplatData.from_arrays(*bench_arrays().values(), scene_scale=3.0, device=dev)
        cams = bench_cameras()
        _, cap = snug_cap(splats, cams)
        fps = sorted(benchmark_fps(splats, n_frames=20, instance_cap=cap, cameras=cams)
                     for _ in range(5))
    out["orbit_fps_median_of_5"] = fps[2]
    return out


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
    print(json.dumps({"root": ns.root, "card": card, **kernel_times(dev), **path_rates(dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
