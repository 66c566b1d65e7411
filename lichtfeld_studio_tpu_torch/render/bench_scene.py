"""The render benchmark's scene and cameras (tools/bench_render.py): 660,000
gaussians uniform in [-3, 3]^3, random DC colour, SH degree 3 with zero
higher bands, sigma 0.02, opacity 0.5, seed 0; 8 cameras on a radius-8
orbit, fx = fy = 1500, 1920x1080."""

from __future__ import annotations

import numpy as np

from lichtfeld_studio_tpu_torch.core.camera import Camera, look_at_camera

N_BENCH = 660_000
WIDTH, HEIGHT = 1920, 1080


def bench_arrays(n: int = N_BENCH, seed: int = 0) -> dict[str, np.ndarray]:
    """SplatData.from_arrays fields, in its argument order."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return dict(
        means=pos,
        sh0=((col - 0.5) / 0.2821)[:, None, :],
        shN=np.zeros((n, 15, 3), np.float32),
        scaling=np.full((n, 3), np.log(0.02), np.float32),
        rotation=np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)),
        opacity=np.zeros((n, 1), np.float32),
    )


def bench_cameras(width: int = WIDTH, height: int = HEIGHT) -> list[Camera]:
    return [
        look_at_camera(8.0 * np.array([np.sin(th), -0.1, -np.cos(th)]), np.zeros(3),
                       np.array([0.0, -1.0, 0.0]), 1500.0, 1500.0, width, height)
        for th in (2 * np.pi * k / 8 for k in range(8))
    ]
