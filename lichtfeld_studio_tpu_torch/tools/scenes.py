"""The synthetic scenes that chip_smoke.py, the kernel tools and bench_dp.py
run on, the card's name, a few untimed train steps on a scene, and one
inference frame of the model they leave.

* the orbit scene: 660,000 gaussians uniform in [-3, 3]^3, random DC
  colour, SH degree 3 with zero higher bands, sigma 0.02, opacity 0.5,
  seed 0; 8 cameras on a radius-8 orbit, fx = fy = 1500, 1920x1080;
* the train scene (bench.py's geometry): a 1M-capacity model with 600k
  live gaussians of the same kind, one camera at distance 8, fx = fy =
  1000, a 1296x840 random target, 32-px tiles, instance cap 1.4M, the MCMC
  configuration with a refine every 10 steps;
* the gut scene: the train scene through an OPENCV_FISHEYE camera with
  radial (0.08, -0.01, 0, 0), the --gut-exact configuration (UT projection,
  world-space blend), instance cap 1.5M (the conservative UT bounds bin
  more instances than the 2D path's exact tile test).

Rates are measured by the benchmark (port_bench), not here.
"""

from __future__ import annotations

import dataclasses
import subprocess

import numpy as np
import torch

from lichtfeld_studio_tpu_torch.core.camera import Camera, CameraModelType, look_at_camera
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize
from lichtfeld_studio_tpu_torch.train.state import (
    StepFlags,
    TrainConfig,
    init_train_state,
    make_lrs,
    train_step,
)
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig

ORBIT_N = 660_000
ORBIT_WIDTH, ORBIT_HEIGHT = 1920, 1080

TRAIN_WIDTH, TRAIN_HEIGHT = 1296, 840
TRAIN_CAP = 1_000_000
TRAIN_N0 = 600_000
TRAIN_ICAP = 1_400_000
GUT_ICAP = 1_500_000
FISHEYE_RADIAL = (0.08, -0.01, 0.0, 0.0)
# The plain steps before the refines that leave the trained models the
# kernels are measured on again ("trained" in chip_smoke.py's kernels line).
TRAIN_PLAIN_STEPS = 125
GUT_PLAIN_STEPS = 50


def orbit_scene(n: int = ORBIT_N, seed: int = 0) -> dict[str, np.ndarray]:
    """SplatData.from_arrays fields of the orbit scene, in its argument order."""
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


def orbit_cameras(n_views: int, radius: float, focal: float, width: int, height: int,
                  lift: float = -0.25) -> list[Camera]:
    """`n_views` cameras evenly around the y axis at `radius` (height
    `lift * radius`), looking at the origin; the orbit scene's are
    orbit_cameras(8, 8.0, 1500.0, ORBIT_WIDTH, ORBIT_HEIGHT, lift=-0.1)."""
    cams = []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        eye = radius * np.array([np.sin(theta), lift, -np.cos(theta)])
        cams.append(look_at_camera(eye, np.zeros(3), np.array([0.0, -1.0, 0.0]),
                                   fx=focal, fy=focal, width=width, height=height, uid=i))
    return cams


def train_scene(device, *, n0=TRAIN_N0, cap=TRAIN_CAP, width=TRAIN_WIDTH, height=TRAIN_HEIGHT,
                instance_cap=TRAIN_ICAP):
    """The train scene's splats, camera, target, background, config and
    LRs (seed 0); the keywords shrink it (small scenes for tests)."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-3, 3, (n0, 3)).astype(np.float32)
    col = rng.uniform(0, 1, (n0, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    pad = cap - n0
    splats = SplatData(
        means=t(np.pad(pos, ((0, pad), (0, 0)))),
        sh0=t(np.pad(((col - 0.5) / 0.2821)[:, None, :], ((0, pad), (0, 0), (0, 0)))),
        shN=torch.zeros((cap, 15, 3), device=device),
        scaling=torch.full((cap, 3), float(np.log(0.02)), device=device),
        rotation=t(np.tile([[1.0, 0.0, 0.0, 0.0]], (cap, 1))),
        opacity=torch.zeros((cap, 1), device=device),
        n_active=n0, active_sh_degree=3, max_sh_degree=3, scene_scale=3.0,
    )
    cam = look_at_camera(np.array([0.0, 0.0, -8.0]), np.zeros(3), np.array([0.0, -1.0, 0.0]),
                         1000.0, 1000.0, width, height).device_params(device)
    cfg = TrainConfig(
        raster_mode="cuda", tile_size=32, instance_cap=instance_cap,
        mcmc=MCMCConfig(max_cap=cap, start_refine=5, stop_refine=1000, refine_every=10),
        lr_gamma=0.01 ** (1.0 / 30_000),
    )
    lrs = make_lrs(1.6e-5, 2.5e-3, 5e-3, 1e-3, 0.05, splats.scene_scale)
    return splats, cam, t(gt), torch.zeros(3, device=device), cfg, lrs


def gut_scene(device, *, instance_cap=GUT_ICAP, **sizes):
    """train_scene through the fisheye camera, with the --gut-exact config."""
    splats, cam, gt, bg, cfg, lrs = train_scene(device, instance_cap=instance_cap, **sizes)
    cam = dataclasses.replace(cam, camera_model=CameraModelType.OPENCV_FISHEYE,
                              radial=torch.tensor(FISHEYE_RADIAL, device=device))
    return splats, cam, gt, bg, dataclasses.replace(cfg, projection="ut", gut_exact=True), lrs


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def train_briefly(device, setup=train_scene, plain_steps: int = TRAIN_PLAIN_STEPS,
                  refine_steps: int = 3, **sizes) -> dict:
    """`plain_steps` plain train steps, then `refine_steps` refine steps
    (relocation and growth) on `setup`'s scene (train_scene or gut_scene;
    `sizes` goes to it). Untimed. Returns the state, the inputs (camera,
    target, background, config) and the steps' health: every loss finite,
    the largest instance count beside the cap, the largest count of
    non-finite entries, and n_active before and after the refines."""
    splats, cam, gt, bg, cfg, lrs = setup(device, **sizes)
    state = init_train_state(splats, lrs, seed=0)
    seen = []
    for _ in range(plain_steps):
        state, m = train_step(state, cam, gt, bg, cfg, StepFlags())
        seen.append(m)
    n_before = int(state.splats.n_active)
    for _ in range(refine_steps):
        state, m = train_step(state, cam, gt, bg, cfg, StepFlags(refine=True))
        seen.append(m)
    m = {k: torch.stack([s[k] for s in seen]) for k in seen[0]}
    return {
        "state": state,
        "inputs": (cam, gt, bg, cfg),
        "steps": len(seen),
        "loss_first": float(m["loss"][0]),
        "loss_last": float(m["loss"][-1]),
        "all_losses_finite": bool(torch.isfinite(m["loss"]).all()),
        "max_n_instances": int(m["n_instances"].max()),
        "instance_cap": cfg.instance_cap,
        "max_n_nonfinite": int(m["n_nonfinite"].max()),
        "n_active_before_refine": n_before,
        "n_active_after_refine": int(state.splats.n_active),
    }


def inference_frame(r: dict) -> dict:
    """One inference frame of the model that train_briefly left (`r`), on
    its camera and config (for the gut scene: the --gut-exact forward-only
    frame): whether it is finite, and its instance count."""
    cam, _, bg, cfg = r["inputs"]
    with torch.no_grad():
        frame = rasterize(r["state"].splats, cam, bg, mode=cfg.raster_mode,
                          instance_cap=cfg.instance_cap, projection=cfg.projection,
                          gut_exact=cfg.gut_exact, inference=True)
    return {"frame_finite": bool(torch.isfinite(frame.image).all()),
            "frame_n_instances": int(frame.n_instances)}
