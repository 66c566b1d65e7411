"""The --gut-exact MCMC train step and forward frame on one NVIDIA GPU
(counterpart of tools/bench_world_blend.py, which times the JAX package).

bench_train.py's scene at its full width (1M capacity, 600k live gaussians
uniform in [-3, 3]^3, sigma 0.02, opacity 0.5, SH degree 3, a random
1296x840 target, seed 0, one camera at distance 8, fx = fy = 1000), seen
through an OPENCV_FISHEYE camera with radial (0.08, -0.01, 0, 0): the UT
projection with full bboxes, the per-pixel world ray table and the exact
world-space blend (kernels P5 forward, P6 and P4 backward), 32-px tiles,
instance cap 1.5M (the conservative UT bounds bin more instances than the
2D path's exact tile test). Plain steps run in dispatches through
train_steps_scanned, refine steps are timed on their own and amortised at
one per 100; then the forward-only frame (rasterize inference=True).

    python -m lichtfeld_studio_tpu_torch.bench_gut

prints ONE JSON line (metric gut_exact_fisheye_train_step, it/s, and
forward_fps) and the card's name and power limit on stderr. Needs a CUDA
device.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from lichtfeld_studio_tpu_torch import bench_train
from lichtfeld_studio_tpu_torch.core.camera import CameraModelType
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize

ICAP = 1_500_000
FISHEYE_RADIAL = (0.08, -0.01, 0.0, 0.0)
METRIC = "gut_exact_fisheye_train_step"


def bench_setup(device, *, instance_cap=ICAP, **sizes):
    """bench_train's scene and target through the fisheye camera, with the
    --gut-exact config."""
    splats, cam, gt, bg, cfg, lrs = bench_train.bench_setup(device, instance_cap=instance_cap,
                                                            **sizes)
    cam = dataclasses.replace(cam, camera_model=CameraModelType.OPENCV_FISHEYE,
                              radial=torch.tensor(FISHEYE_RADIAL, device=device))
    return splats, cam, gt, bg, dataclasses.replace(cfg, projection="ut", gut_exact=True), lrs


@torch.no_grad()
def forward_frame(state, cam, bg, cfg):
    """The forward-only --gut-exact frame (32-px tiles, no gradient layout)."""
    return rasterize(state.splats, cam, bg, mode=cfg.raster_mode, instance_cap=cfg.instance_cap,
                     projection=cfg.projection, gut_exact=cfg.gut_exact, inference=True)


def benchmark_gut(device="cuda", *, frames=5, log=None, **kw) -> dict:
    """bench_train.benchmark_train's protocol on bench_setup, then `frames`
    forward frames of the trained state, host clock around work that ends
    in a synchronise. `kw` goes to benchmark_train (step counts, sizes)."""
    log = log or (lambda msg: None)
    r = bench_train.benchmark_train(device, setup=bench_setup, log=log, **kw)
    cam, _, bg, cfg = r["inputs"]
    out = forward_frame(r["state"], cam, bg, cfg)  # warm-up
    bench_train._sync(device)
    t0 = time.perf_counter()
    for _ in range(frames):
        out = forward_frame(r["state"], cam, bg, cfg)
    bench_train._sync(device)
    r["forward_ms"] = 1e3 * (time.perf_counter() - t0) / frames
    r["forward_fps"] = 1e3 / r["forward_ms"]
    r["forward_n_instances"] = int(out.n_instances)
    r["forward_finite"] = bool(torch.isfinite(out.image).all())
    log(f"forward frame {r['forward_ms']:.2f} ms -> {r['forward_fps']:.2f} FPS, "
        f"{r['forward_n_instances']} instances")
    return r


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_gut needs an NVIDIA GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    print(f"card: {bench_train.card()}", file=sys.stderr, flush=True)
    r = benchmark_gut("cuda", log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps({
        "metric": METRIC,
        "value": round(r["it_s"], 3),
        "unit": "it/s",
        "forward_fps": round(r["forward_fps"], 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
