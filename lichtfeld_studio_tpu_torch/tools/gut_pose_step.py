"""One --gut-exact train step with pose optimisation at bench_gut's full
width, on one NVIDIA GPU: bench_gut.bench_setup (600k live gaussians,
1296x840, OPENCV_FISHEYE) with pose_mode="direct". A pose gradient takes
the exact path's dense route (ops/world_blend.py::world_blend_tiles under
autograd, the ray table in the graph), as it does in the JAX package, so
this step runs no P5/P6. Beside it, in the same process, the same step
without pose optimisation (the P5/P6 route).

    python -m lichtfeld_studio_tpu_torch.tools.gut_pose_step

prints the card's name and power limit, then one JSON line per route:
the step's milliseconds (host clock around steps that end in a
synchronise, after a warm-up step) and the peak device memory
(torch.cuda.max_memory_allocated). A route that runs out of device memory
reports `"out_of_memory": true` and the peak it reached. Needs a CUDA
device.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from lichtfeld_studio_tpu_torch import bench_gut, bench_train
from lichtfeld_studio_tpu_torch.train.state import init_train_state, step_flags, train_step


def time_step(pose_mode: str, steps: int = 2) -> dict:
    splats, cam, gt, bg, cfg, lrs = bench_gut.bench_setup("cuda")
    cfg = dataclasses.replace(cfg, pose_mode=pose_mode)
    state = init_train_state(splats, lrs, cfg=cfg, num_cameras=1)
    flags = step_flags(cfg, 2000)  # a plain step (no refine, shN trained)
    out = {"route": "dense (cam_grad)" if pose_mode != "none" else "P5/P6",
           "pose_mode": pose_mode}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        state, m = train_step(state, cam, gt, bg, cfg, flags)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = train_step(state, cam, gt, bg, cfg, flags)
        torch.cuda.synchronize()
        out.update(step_ms=1e3 * (time.perf_counter() - t0) / steps, loss=float(m["loss"]),
                   n_instances=int(m["n_instances"]), out_of_memory=False)
    except torch.cuda.OutOfMemoryError as e:
        out.update(out_of_memory=True, error=str(e).splitlines()[0])
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    del state, splats
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gut_pose_step needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    print(f"card: {bench_train.card()}", flush=True)
    for mode in ("none", "direct"):
        print(json.dumps(time_step(mode)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
