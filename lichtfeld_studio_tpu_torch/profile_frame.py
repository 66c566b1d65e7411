"""Trace of the headless 1080p frame on one NVIDIA GPU: kernel launches per
frame, host enqueue time against wall time, and the device's busy share.

    python -m lichtfeld_studio_tpu_torch.profile_frame [--trace out.json]

It renders the benchmark scene (render/bench_scene.py) over its 8 cameras at
the probe-snug cap, 8 frames at a time as benchmark_fps renders them, in
two passes:

1. untraced: host milliseconds per frame until the last call returns (the
   enqueue), and wall milliseconds per frame until the device drains;
2. under profiling.device_trace: device events (kernels, copies, fills)
   per frame, their summed time, and the union of their intervals against
   the span from the first to the last, which gives the device's busy
   share; then the kernels that take the most device time, and the device
   time of each stage of rasterize (profiling.stage_device_ms).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.profiling import device_summary, device_trace, stage_device_ms
from lichtfeld_studio_tpu_torch.render.bench_scene import bench_arrays, bench_cameras
from lichtfeld_studio_tpu_torch.render.headless import render_frame_u8, snug_cap

N_FRAMES = 8


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", help="also write a Chrome trace to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: profile_frame needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda")
    n = N_FRAMES
    with torch.no_grad():
        splats = SplatData.from_arrays(*bench_arrays().values(), scene_scale=3.0, device=dev)
        cams = bench_cameras()
        peak, cap = snug_cap(splats, cams)
        params = [c.device_params(dev) for c in cams]
        bg = torch.zeros(3, device=dev)

        def frames():
            for k in range(n):
                render_frame_u8(splats, params[k % len(params)], bg, "cuda", cap)

        frames()  # warm-up: kernel build, allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"[untraced] {n} frames, cap {cap} (peak {peak}): host enqueue "
              f"{1e3 * (t1 - t0) / n:.3f} ms/frame, then drain {1e3 * (t2 - t1) / n:.3f} "
              f"ms/frame, wall {1e3 * (t2 - t0) / n:.3f} ms/frame | {card}")

        with device_trace() as prof:
            t0 = time.perf_counter()
            frames()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    d = device_summary(prof)
    if d is None:
        print(f"[trace] wall {1e3 * (t2 - t0) / n:.3f} ms/frame; the trace holds no device "
              f"events | {card}")
        return 0
    print(f"[trace] {n} frames: {d['events'] / n:.1f} device events/frame "
          f"({(d['events'] - d['copies']) / n:.1f} kernels, {d['copies'] / n:.1f} copies/fills); "
          f"device time summed {d['summed_us'] / 1e3 / n:.3f} ms/frame, busy (union) "
          f"{d['busy_us'] / 1e3 / n:.3f} ms/frame over a device span of "
          f"{d['span_us'] / 1e3 / n:.3f} ms/frame: busy share {d['busy_us'] / d['span_us']:.3f}; "
          f"wall under the profiler {1e3 * (t2 - t0) / n:.3f} ms/frame | {card}")
    for name, count, us in d["top"]:
        print(f"[trace]   {us / 1e3 / n:8.3f} ms/frame {count / n:6.1f}x/frame  {name[:110]}")
    print("[trace] stage device ms/frame: " + ", ".join(
        f"{k} {v / n:.3f}" for k, v in sorted(stage_device_ms(prof).items())) + f" | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
