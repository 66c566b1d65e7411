"""A/B of the kernels of two checkouts of the port on one NVIDIA GPU: the
instance expansion P1, the tile blends P2 (training and inference), P3, P5
and P6, and the segment reduce P4, one checkout a process. Rates are the
benchmark's (port_bench). Numbers move between machines and between calls,
so compare two commits by running this file on both in turns, in one go on
one card:

    git archive <parent> | tar -x -C build/parent
    for root in build/parent . . build/parent; do
        python lichtfeld_studio_tpu_torch/tools/ab_kernels.py --root $root
    done

Run by path, not with -m: `--root` decides which checkout's package is
imported, and only what both must have is used (the wrappers,
tools/scenes.py, rasterize and ops.rasterize.capture_world_inputs,
render.headless, ops.tiles.pack_payload and the C entry
lfs_expand_instances): both checkouts need tools/scenes.py.
The first line is the card's name and power limit, the last one JSON
object. The kernels run at chip_smoke.py's shapes: P1 on the render
scene's view 0 (cap 2^21) and on the train scene (1M capacity, cap
1.4M), beside torch.searchsorted on the same ends and slots (it computes
the owner only); P2 inference on the render scene at 1080p (view 0), P2
training, P3 and P4 on the train scene, P5 and P6 on the gut scene's
fisheye camera (P5 also on the forward frame's binning); P2 training, P3,
P5 and P6 again on the binning of the models that scenes.train_briefly
leaves on the train and gut scenes after their steps and refines
("trained"). P4 is timed on P3's rows (9 columns) and on random rows of
24 columns with the same offsets (the width of the world blend's rows), beside
torch.segment_reduce on the same rows. `*_sha` are digests of the
kernels' outputs (P5's image, T_final and `last`; P6's rows): equal
digests in two checkouts are equal bits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
        # (image, alpha, t_final, last[, tile_neff where the checkout trims])
        t_final, last, *trim = kblend.blend_forward(*args, **kw, train=True)[2:]
        gen = torch.Generator(device=proj.mean2d.device).manual_seed(tile_size)
        d_image = torch.randn(t_final.shape + (3,), generator=gen, device=t_final.device)
        d_alpha = torch.randn(t_final.shape, generator=gen, device=t_final.device)
    bwd = (a.tile_start, a.tile_count, a.gaussian_idx, a.slot_layout, *args[3:],
           t_final, last, *trim, d_image, d_alpha)
    return a, bwd, kw


def bench_kernel_inputs(dev):
    """The train scene binned as its step bins it (blend_inputs)."""
    from lichtfeld_studio_tpu_torch.tools import scenes

    sd, cam, _, _, cfg, _ = scenes.train_scene(dev)
    return blend_inputs(sd, cam, tile_size=cfg.tile_size, instance_cap=cfg.instance_cap)


def render_kernel_inputs(dev):
    """The render scene's view 0 at 1080p binned as the render bins it at
    the probe-snug cap: (assignment, blend_forward's arguments, keywords)."""
    import torch

    from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
    from lichtfeld_studio_tpu_torch.render.headless import snug_cap
    from lichtfeld_studio_tpu_torch.tools import scenes

    with torch.no_grad():
        splats = SplatData.from_arrays(*scenes.orbit_scene().values(), scene_scale=3.0,
                                       device=dev)
        cams = scenes.orbit_cameras(8, 8.0, 1500.0, scenes.ORBIT_WIDTH, scenes.ORBIT_HEIGHT,
                                    lift=-0.1)
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


def gut_kernel_inputs(dev, inference=False):
    """The gut scene (world_kernel_inputs); with `inference`, the forward
    frame's binning instead: (world_blend_forward's arguments, its
    keywords)."""
    from lichtfeld_studio_tpu_torch.ops.rasterize import capture_world_inputs
    from lichtfeld_studio_tpu_torch.tools import scenes

    sd, cam, _, _, cfg, _ = scenes.gut_scene(dev)
    if inference:
        *fwd, kw = capture_world_inputs(sd, cam, tile_size=cfg.tile_size,
                                        instance_cap=cfg.instance_cap, inference=True)
        return tuple(fwd), kw
    return world_kernel_inputs(sd, cam, tile_size=cfg.tile_size, instance_cap=cfg.instance_cap)


def expand_kernel_inputs(dev) -> dict:
    """P1's inputs at the two shapes of the main paths: the render scene's
    view 0 at 1080p (cap 2^21) and the train scene (1M capacity, 600k
    live, cap 1.4M): name -> (n_touched, payload_t, cap)."""
    import torch

    from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
    from lichtfeld_studio_tpu_torch.ops.rasterize import _project
    from lichtfeld_studio_tpu_torch.ops.tiles import pack_payload
    from lichtfeld_studio_tpu_torch.tools import scenes

    out = {}
    with torch.no_grad():
        splats = SplatData.from_arrays(*scenes.orbit_scene().values(), scene_scale=3.0,
                                       device=dev)
        cam = scenes.orbit_cameras(8, 8.0, 1500.0, scenes.ORBIT_WIDTH, scenes.ORBIT_HEIGHT,
                                   lift=-0.1)[0]
        proj = _project(splats, cam.device_params(dev), tile_size=32)
        cap = max(1 << 21, -(-int(proj.n_touched.sum()) // 1024) * 1024)
        out["render"] = (proj.n_touched, pack_payload(proj), cap)
        sd, cam, _, _, cfg, _ = scenes.train_scene(dev)
        proj = _project(sd, cam, tile_size=cfg.tile_size)
        out["train"] = (proj.n_touched, pack_payload(proj), cfg.instance_cap)
    return out


def expand_check(nt, payload, cap: int) -> dict:
    """P1 on one input: whether the kernel is the plain version (the same
    valid slots, equal owner, rank and payload on them, owners in bounds
    everywhere), the largest difference on a valid slot, a digest of its
    outputs, and device ms of the wrapper (the
    cumsum and the kernel, host-bound back to back), of the C entry alone
    on the same ends, and of torch.searchsorted on the same ends and slots
    (it computes the owner only)."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import _build
    from lichtfeld_studio_tpu_torch.kernels import expand as kexpand
    from lichtfeld_studio_tpu_torch.profiling import device_ms

    dev = nt.device
    got = kexpand.expand_instances(nt, payload, cap)
    want = kexpand.expand_instances_plain(nt, payload, cap)
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = (slots < int(nt.sum())) & (want[1] < nt[want[0].long()])
    valid_got = (slots < int(nt.sum())) & (got[1] < nt[got[0].long()])
    err = max(int((x[..., valid] - y[..., valid]).abs().max()) if int(valid.sum()) else 0
              for x, y in zip(got, want))
    exact = (torch.equal(valid, valid_got) and bool((got[0] >= 0).all())
             and bool((got[0] < nt.shape[0]).all()) and err == 0)
    lib = _build.load_library()
    ends = torch.cumsum(nt, 0, dtype=torch.int32)
    g, rank, pl = (torch.empty_like(t) for t in got)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def entry():
        _build.check(lib.lfs_expand_instances(ends.data_ptr(), payload.data_ptr(), nt.shape[0],
                                              cap, g.data_ptr(), rank.data_ptr(), pl.data_ptr(),
                                              stream), "lfs_expand_instances")

    return {"exact": exact, "err": err, "valid": int(valid.sum()), "sha": digest(*got),
            "outputs": got,
            "n": [int(nt.shape[0]), int(nt.sum()), cap],
            "ms": device_ms(lambda: kexpand.expand_instances(nt, payload, cap)),
            "kernel_ms": device_ms(entry),
            "library_ms": device_ms(lambda: torch.searchsorted(ends, slots, right=True))}


def expand_times(dev) -> dict:
    """expand_check at expand_kernel_inputs' shapes."""
    out = {}
    for name, inputs in expand_kernel_inputs(dev).items():
        r = expand_check(*inputs)
        out.update({f"p1_{name}_exact": r["exact"], f"p1_{name}_sha": r["sha"],
                    f"p1_{name}_n": r["n"], f"p1_{name}_ms": r["ms"],
                    f"p1_{name}_kernel_ms": r["kernel_ms"],
                    f"searchsorted_{name}_ms": r["library_ms"]})
    return out


def kernel_times(dev) -> dict:
    """P1, P2 (both variants), P3, P4, P5 and P6 at chip_smoke.py's shapes
    on the fresh scenes: device ms of the wrappers."""
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
        out.update(world_times(a, wbwd, grid))
        del a, wbwd
        fwd, kw = gut_kernel_inputs(dev, inference=True)
        out["p5_frame_instances"] = int(fwd[4].sum())
        out["p5_frame_sha"] = digest(*kwb.world_blend_forward(*fwd, **kw))
        out["p5_frame_ms"] = device_ms(lambda: kwb.world_blend_forward(*fwd, **kw))
    out.update(expand_times(dev))
    return out


def world_times(a, wbwd, grid, tag="") -> dict:
    """P5 and P6 on world_kernel_inputs' result: device ms and digests."""
    from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb
    from lichtfeld_studio_tpu_torch.profiling import device_ms

    fwd, kw = wbwd[:6], dict(grid, n_channels=wbwd[9].shape[-1])
    return {f"p6{tag}_instances": int(a.n_instances),
            f"p5{tag}_sha": digest(*kwb.world_blend_forward(*fwd, **kw)),
            f"p5{tag}_ms": device_ms(lambda: kwb.world_blend_forward(*fwd, **kw)),
            f"p6{tag}_sha": digest(kwb.world_blend_backward(*wbwd, **grid)),
            f"p6{tag}_ms": device_ms(lambda: kwb.world_blend_backward(*wbwd, **grid))}


def trained_kernel_times(dev) -> dict:
    """P2 training, P3, P5 and P6 on the binning of the models that
    scenes.train_briefly leaves on the train and the gut scene, as
    chip_smoke.py trains them."""
    import torch

    from lichtfeld_studio_tpu_torch.kernels import blend as kblend
    from lichtfeld_studio_tpu_torch.profiling import device_ms
    from lichtfeld_studio_tpu_torch.tools import scenes

    train_r = scenes.train_briefly(dev, scenes.train_scene, scenes.TRAIN_PLAIN_STEPS)
    gut_r = scenes.train_briefly(dev, scenes.gut_scene, scenes.GUT_PLAIN_STEPS)
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
        out.update(world_times(a, wbwd, grid, "_trained"))
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
    from lichtfeld_studio_tpu_torch.tools import scenes

    card = scenes.card()
    print(card, flush=True)
    dev = torch.device("cuda")
    fresh = kernel_times(dev)
    torch.cuda.empty_cache()
    trained = trained_kernel_times(dev)
    print(json.dumps({"root": ns.root, "card": card, **fresh, **trained}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
