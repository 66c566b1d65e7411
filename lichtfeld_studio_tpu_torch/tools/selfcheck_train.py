"""End-to-end training self-check on one NVIDIA GPU (counterpart of
tools/selfcheck_train.py): write a synthetic multi-view dataset with the
port's own renderer, train from random init through the CLI's argument
parser and the Trainer, and gate the result.

    python -m lichtfeld_studio_tpu_torch.tools.selfcheck_train \
        [--iters 2000] [--strategy mcmc|default] [--root build/selfcheck] [--scene-only]

The scene: 24 views, 512x384, of 20,000 clustered coloured gaussians
(seed 7), as a Blender-style transforms.json. Gates:

* every PSNR and the final loss finite;
* SSIM: up to 5000 iterations the last eval beats the first (at a quarter
  of the run) by more than 0.1; longer runs must not fall by 0.005;
* kernel parity on the trained model: the kernel path (P1 + P2) against
  the dense oracle, median |diff| < 2e-3 and > 99.5 % of the values within
  0.05;
* the same for the exact world-space blend (P1 + P5) through a fisheye
  camera against the dense per-tile oracle.

--iters 30000 is the full-length protocol. With --strategy default (ADC)
the run starts from 10,000 points and keeps one opacity reset inside short
runs (--reset-every min(3000, iters // 2)); its SSIM must not fall, and
the result carries the smallest live count of the run (the first refine
after a reset prunes most of the model, which then regrows: past its
starting size from about 2000 iterations on; a run of 1200 or fewer resets
a model that has barely formed and keeps a few hundred gaussians at most).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from lichtfeld_studio_tpu_torch.core.camera import CameraModelType, CameraParams, look_at_camera
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.io.image import save_image
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize
from lichtfeld_studio_tpu_torch.tools.scenes import orbit_cameras

WIDTH, HEIGHT, N_VIEWS, N_GT, FOCAL, SEED = 512, 384, 24, 20_000, 450.0, 7
PARITY_MEDIAN, PARITY_WITHIN, PARITY_FRAC = 2e-3, 0.05, 0.995
FISHEYE_RADIAL = (0.08, -0.01, 0.0, 0.0)


def write_transforms_scene(scene: Path, splats: SplatData, cameras, *, instance_cap: int) -> None:
    """Render `splats` through each camera with the port's renderer and
    write the views as a Blender-style transforms.json dataset under
    `scene` (images/r_###.png). All cameras share one focal length."""
    (scene / "images").mkdir(parents=True, exist_ok=True)
    dev = splats.means.device
    frames = []
    for i, cam in enumerate(cameras):
        with torch.no_grad():
            img = rasterize(splats, cam.device_params(dev), torch.zeros(3, device=dev),
                            mode="cuda", instance_cap=instance_cap, inference=True).image
        name = f"images/r_{i:03d}.png"
        save_image(str(scene / name), torch.clamp(img, 0, 1).cpu().numpy())
        # w2c -> c2w with the OpenGL axis flip that the loader inverts
        c2w = np.linalg.inv(cam.w2c.astype(np.float64))
        c2w[:3, 1:3] *= -1.0
        frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
    fov_x = 2.0 * np.arctan(cameras[0].width / (2 * cameras[0].fx))
    (scene / "transforms.json").write_text(
        json.dumps({"camera_angle_x": fov_x, "frames": frames}))


def write_scene(scene: Path, device, *, width: int = WIDTH, height: int = HEIGHT,
                n_views: int = N_VIEWS, n_gt: int = N_GT, focal: float = FOCAL,
                seed: int = SEED) -> None:
    """The self-check's ground-truth scene (clustered coloured gaussians,
    opacity 0.8, sigma 0.03) and its dataset."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 0.8, (30, 3))
    which = rng.integers(0, 30, n_gt)
    pos = (centers[which] + rng.normal(0, 0.15, (n_gt, 3))).astype(np.float32)
    col = rng.uniform(0.05, 0.95, (30, 3))[which].astype(np.float32)
    gt = SplatData.from_point_cloud(pos, col, np.zeros(3, np.float32), capacity=n_gt,
                                    device=device)
    gt.replace_trainable({
        "opacity": torch.full((n_gt, 1), float(np.log(0.8 / 0.2)), device=device),
        "scaling": torch.full((n_gt, 3), float(np.log(0.03)), device=device),
    })
    write_transforms_scene(scene, gt, orbit_cameras(n_views, 4.5, focal, width, height),
                           instance_cap=2**20)


@torch.no_grad()
def kernel_parity(splats: SplatData, cam: CameraParams, *, instance_cap: int,
                  gut_exact: bool = False, tile_size: int = 32) -> tuple[float, float]:
    """(median |kernel - oracle|, share of values within PARITY_WITHIN) of
    a forward frame through the kernel path (P1 + P2, or P1 + P5 with
    `gut_exact`) against the dense oracle on the same model."""
    bg = torch.zeros(3, device=splats.means.device)
    kw = dict(instance_cap=instance_cap, tile_size=tile_size)
    if gut_exact:
        kw.update(projection="ut", gut_exact=True)
    a = rasterize(splats, cam, bg, mode="cuda", inference=True, **kw).image
    b = rasterize(splats, cam, bg, mode="oracle", **kw).image
    err = (a - b).abs()
    return float(err.median()), float((err < PARITY_WITHIN).float().mean())


def parity_ok(med: float, frac: float) -> bool:
    return med < PARITY_MEDIAN and frac > PARITY_FRAC


def train_argv(scene: Path, out: Path, iters: int, strategy: str) -> list[str]:
    evals = [str(max(iters // 4, 1)), str(iters)]
    argv = [
        "-d", str(scene), "-o", str(out), "--headless", "--eval",
        "--test-every", "8", "--iterations", str(iters),
        "--eval-steps", *evals, "--save-steps", str(iters),
        "--max-cap", "200000", "--instance-cap", str(2**21),
        "--strategy", strategy,
        "--start-refine", "300", "--stop-refine", str(int(iters * 0.9)),
        "--refine-every", "100",
        "--sh-degree", "3", "--random",
        "--init-num-pts", "20000",
    ]
    if strategy == "default":
        # ADC grows by split and clone: start small so that growth fits
        # max-cap, and keep the opacity resets on the reference 3k cadence
        # (scaled in at short lengths so that a short run still crosses one)
        argv += ["--reset-every", str(min(3000, max(iters // 2, 1)))]
        argv[argv.index("--init-num-pts") + 1] = "10000"
    return argv


def run(root: Path, iters: int, strategy: str, device, *, parity: bool = True,
        log=print) -> dict:
    """Train on the scene under `root` (written if missing) and gate the
    result; raises AssertionError on a failed gate. Returns the numbers."""
    from lichtfeld_studio_tpu_torch.cli import parse_args_and_params
    from lichtfeld_studio_tpu_torch.train.trainer import Trainer

    device = torch.device(device)
    scene, out = root / "scene", root / f"out_{strategy}"
    if not (scene / "transforms.json").exists():
        write_scene(scene, device)
        log("dataset written")
    trainer = Trainer.setup(parse_args_and_params(train_argv(scene, out, iters, strategy)), device)
    n0 = int(trainer.state.splats.n_active)
    counts = [n0]
    trainer.progress_callback = lambda it, loss, n: counts.append(n)
    stats = trainer.train()
    losses = stats.pop("losses")
    log(f"train stats: {stats}")
    csv = (out / "metrics.csv").read_text()
    log(csv)
    rows = csv.strip().splitlines()[1:]
    psnrs = [float(r.split(",")[1]) for r in rows]
    ssims = [float(r.split(",")[2]) for r in rows]
    assert np.isfinite(psnrs).all() and np.isfinite(losses).all(), (psnrs, stats)
    if strategy == "mcmc" and iters <= 5000:
        # a short run evaluates in the middle of the fog clean-up, where
        # SSIM still moves a lot
        assert ssims[-1] > ssims[0] + 0.1, (psnrs, ssims)
    else:
        assert ssims[-1] >= ssims[0] - 0.005, (psnrs, ssims)
    result = {"strategy": strategy, "iters": iters, "psnr": psnrs, "ssim": ssims,
              "n_init": n0, "min_gaussians": min(counts), **stats}
    if parity:
        cam = look_at_camera(
            4.5 * np.array([np.sin(0.7), -0.25, -np.cos(0.7)]), np.zeros(3),
            np.array([0.0, -1.0, 0.0]), fx=FOCAL, fy=FOCAL, width=WIDTH, height=HEIGHT,
        ).device_params(device)
        splats = trainer.state.splats
        med, frac = kernel_parity(splats, cam, instance_cap=2**21)
        log(f"kernel parity: median |P2 - oracle| = {med:.5f}, within {PARITY_WITHIN}: {frac:.4f}")
        assert parity_ok(med, frac), (med, frac)
        cam_fe = dataclasses.replace(
            cam, camera_model=CameraModelType.OPENCV_FISHEYE,
            radial=torch.tensor(FISHEYE_RADIAL, dtype=torch.float32, device=device))
        medw, fracw = kernel_parity(splats, cam_fe, instance_cap=2**21, gut_exact=True)
        log(f"world-blend parity: median |P5 - dense| = {medw:.5f}, within {PARITY_WITHIN}: "
            f"{fracw:.4f}")
        assert parity_ok(medw, fracw), (medw, fracw)
        result.update(parity=(med, frac), world_parity=(medw, fracw))
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--strategy", default="mcmc", choices=["mcmc", "default"])
    ap.add_argument("--root", default="build/selfcheck")
    ap.add_argument("--scene-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("selfcheck_train needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from lichtfeld_studio_tpu_torch.tools.scenes import card

    print(f"card: {card()}", flush=True)
    root = Path(args.root)
    if args.scene_only:
        write_scene(root / "scene", torch.device("cuda"))
        print("dataset written", flush=True)
        return 0
    r = run(root, args.iters, args.strategy, "cuda")
    print(f"SELFCHECK OK: PSNR {r['psnr']} SSIM {r['ssim']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
