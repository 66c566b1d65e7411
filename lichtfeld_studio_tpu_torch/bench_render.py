"""Headless render throughput on the render cell's scene, on one NVIDIA GPU
(counterpart of tools/bench_render.py, which times the JAX package).

The scene of render/bench_scene.py (660,000 gaussians, SH degree 3) at
1920x1080 through two paths:

* exact: 20 frames cycling over the 8 orbit cameras, each frame projected,
  binned (P1) and blended (P2) at the probe-snug instance cap
  (render/headless.py::benchmark_fps);
* coherent: render/coherent.py's CoherentRenderer over 30 frames of a slow
  inspection drag (0.004 rad over 32 cameras, as tools/bench_render.py),
  re-binning only when the drift bound or max_reuse asks for it.

    python -m lichtfeld_studio_tpu_torch.bench_render

prints two JSON lines like tools/bench_render.py's (metrics
headless_render_fps_1080p_660k and interactive_render_fps_1080p_660k_coherent,
FPS; vs_baseline = FPS / 100, the reference viewer's 1080p headline) and
the card's name and power limit on stderr. Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from lichtfeld_studio_tpu_torch.core.camera import look_at_camera
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.render.bench_scene import (
    HEIGHT,
    N_BENCH,
    WIDTH,
    bench_arrays,
    bench_cameras,
)
from lichtfeld_studio_tpu_torch.render.coherent import CoherentRenderer
from lichtfeld_studio_tpu_torch.render.headless import benchmark_fps, snug_cap

BASELINE_FPS = 100.0  # the reference viewer's >= 100 FPS at 1080p (BASELINE.md)
METRIC_EXACT = "headless_render_fps_1080p_660k"
METRIC_COHERENT = "interactive_render_fps_1080p_660k_coherent"


def drag_cameras(n: int = 32, width: int = WIDTH, height: int = HEIGHT, span: float = 0.004):
    """A slow inspection drag: n cameras over `span` rad of the bench orbit."""
    return [look_at_camera(8.0 * np.array([np.sin(t), -0.1, -np.cos(t)]), np.zeros(3),
                           np.array([0.0, -1.0, 0.0]), 1500.0, 1500.0, width, height)
            for t in np.linspace(0.0, span, n)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def benchmark_render(device, *, n: int = N_BENCH, width: int = WIDTH, height: int = HEIGHT,
                     n_frames: int = 20, n_coherent: int = 30, log=lambda msg: None) -> dict:
    """Frames per second of the exact and the coherent path (u8 frames stay
    on the device), with the instance counts and the coherent renderer's
    bins."""
    device = torch.device(device)
    splats = SplatData.from_arrays(*bench_arrays(n).values(), scene_scale=3.0, device=device)
    cams = bench_cameras(width, height)
    peak, cap = snug_cap(splats, cams)
    log(f"peak instances over the orbit: {peak} -> cap {cap}")
    exact_fps = benchmark_fps(splats, n_frames=n_frames, instance_cap=cap, cameras=cams)

    drag = drag_cameras(n_coherent + 2, width, height)
    r = CoherentRenderer(width, height, tile_size=32, instance_cap=2_097_152)
    r.render(splats, drag[0], as_numpy=False)  # warm-up: the first bin
    _sync(device)
    t0 = time.perf_counter()
    for cam in drag[1:n_coherent + 1]:
        img = r.render(splats, cam, as_numpy=False)
    _sync(device)
    coherent_fps = n_coherent / (time.perf_counter() - t0)
    log(f"exact orbit {exact_fps:.2f} FPS; coherent drag {coherent_fps:.2f} FPS "
        f"({r.stats['bins']} bins / {r.stats['frames']} frames, {r.stats['instances']} "
        f"dilated instances)")
    return {
        "device": str(device) if device.type == "cpu" else torch.cuda.get_device_name(device),
        "exact_fps": exact_fps, "coherent_fps": coherent_fps, "peak_instances": peak,
        "instance_cap": cap, "coherent_bins": r.stats["bins"],
        "coherent_frames": r.stats["frames"], "coherent_instances": r.stats["instances"],
        "coherent_frame_shape": tuple(img.shape),
    }


def json_lines(r: dict) -> list[str]:
    """bench.py-style JSON lines of a benchmark_render result."""
    return [json.dumps({"metric": metric, "value": round(fps, 2), "unit": "FPS",
                        "vs_baseline": round(fps / BASELINE_FPS, 4)})
            for metric, fps in ((METRIC_EXACT, r["exact_fps"]),
                                (METRIC_COHERENT, r["coherent_fps"]))]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_render needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from lichtfeld_studio_tpu_torch.bench_train import card

    print(f"card: {card()}", file=sys.stderr, flush=True)
    r = benchmark_render("cuda", log=lambda msg: print(msg, file=sys.stderr, flush=True))
    for line in json_lines(r):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
