"""MCMC train-step throughput at bench.py's geometry, on one NVIDIA GPU
(counterpart of bench.py, which times the JAX package).

Synthetic stand-in for the MipNeRF360-garden protocol: a 1M-capacity model
with 600k live gaussians (uniform in [-3, 3]^3, sigma 0.02, opacity 0.5,
SH degree 3 with zero higher bands), a 1296x840 random target, 32-px
tiles, an instance cap of 1.4M; the full train step (render -> L1+SSIM ->
backward -> MCMC post_backward -> Adam -> LR schedule). Plain steps run in
dispatches of K_SCAN = 25 through train_steps_scanned; refine steps
(relocation + 5% growth) are timed on their own and amortised at one per
100 steps, the reference MCMC cadence.

    python -m lichtfeld_studio_tpu_torch.bench_train

prints ONE JSON line (metric mcmc_train_step_throughput_1Mcap_1296x840, it/s;
vs_baseline = it/s / 25, the upstream GPU figure of bench.py:9-11) and
the card's name and power limit on stderr. Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from lichtfeld_studio_tpu_torch.core.camera import look_at_camera
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.train.state import (
    StepFlags,
    TrainConfig,
    init_train_state,
    make_lrs,
    train_step,
    train_steps_scanned,
)
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig

WIDTH, HEIGHT = 1296, 840
CAP = 1_000_000
N0 = 600_000
ICAP = 1_400_000
TILE = 32
K_SCAN = 25
BASELINE_ITS = 25.0  # upstream: garden/MCMC 30k iterations in ~20 min (bench.py:9-11)
METRIC = "mcmc_train_step_throughput_1Mcap_1296x840"


def bench_setup(device, *, n0=N0, cap=CAP, width=WIDTH, height=HEIGHT, instance_cap=ICAP):
    """bench.py's scene, camera, target, config and LRs (seed 0)."""
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
        raster_mode="cuda", tile_size=TILE, instance_cap=instance_cap,
        mcmc=MCMCConfig(max_cap=cap, start_refine=5, stop_refine=1000, refine_every=10),
        lr_gamma=0.01 ** (1.0 / 30_000),
    )
    lrs = make_lrs(1.6e-5, 2.5e-3, 5e-3, 1e-3, 0.05, splats.scene_scale)
    return splats, cam, t(gt), torch.zeros(3, device=device), cfg, lrs


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_train(device="cuda", *, k_scan=K_SCAN, warmup=2, dispatches=3, refine_warm=3,
                    refine_timed=2, log=None, setup=bench_setup, **sizes) -> dict:
    """Time bench.py's protocol: one first dispatch of k_scan plain steps,
    `warmup` more, `dispatches` timed; then `refine_warm` + `refine_timed`
    refine steps. Host clock around work that ends in a synchronise.
    Returns the times, it/s amortised at 1 refine per 100 steps, and the
    health of every step's metrics. `setup` builds the scene, camera,
    target, config and LRs (bench_setup; bench_gut.bench_setup for the
    --gut-exact configuration); `sizes` overrides its sizes (small scenes
    for tests)."""
    log = log or (lambda msg: None)
    splats, cam, gt, bg, cfg, lrs = setup(device, **sizes)
    state = init_train_state(splats, lrs, seed=0)
    cams = dataclasses.replace(
        cam, w2c=cam.w2c.expand(k_scan, 4, 4), cam_position=cam.cam_position.expand(k_scan, 3),
        K=cam.K.expand(k_scan, 4))
    gts = gt.expand(k_scan, *gt.shape)
    plain, refine = StepFlags(), StepFlags(refine=True)
    seen = []

    def dispatch():
        nonlocal state
        state, m = train_steps_scanned(state, cams, gts, bg, cfg, plain)
        seen.append(m)
        return m

    t0 = time.perf_counter()
    m = dispatch()
    loss0 = float(m["loss"][-1])
    log(f"first dispatch ({k_scan} steps): {time.perf_counter() - t0:.2f} s, loss {loss0:.4f}, "
        f"instances {int(m['n_instances'][-1])}")
    for _ in range(warmup):
        dispatch()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(dispatches):
        dispatch()
    _sync(device)
    t_plain = (time.perf_counter() - t0) / (dispatches * k_scan)

    n_before = int(state.splats.n_active)
    refine_metrics = []
    for i in range(refine_warm + refine_timed):
        if i == refine_warm:
            _sync(device)
            t0 = time.perf_counter()
        state, m = train_step(state, cam, gt, bg, cfg, refine)
        refine_metrics.append(m)
    _sync(device)
    t_refine = (time.perf_counter() - t0) / max(refine_timed, 1)
    t_amort = (99.0 * t_plain + t_refine) / 100.0

    stacked = {k: torch.cat([s[k] for s in seen] + [torch.stack([m[k] for m in refine_metrics])])
               for k in seen[0]}
    result = {
        "device": str(torch.device(device)) if torch.device(device).type == "cpu"
        else torch.cuda.get_device_name(torch.device(device)),
        "steps": len(stacked["loss"]),
        "refine_steps": refine_warm + refine_timed,
        "plain_ms": 1e3 * t_plain,
        "refine_ms": 1e3 * t_refine,
        "amortized_ms": 1e3 * t_amort,
        "it_s": 1.0 / t_amort,
        "loss_first": loss0,
        "loss_last": float(stacked["loss"][-1]),
        "all_losses_finite": bool(torch.isfinite(stacked["loss"]).all()),
        "max_n_instances": int(stacked["n_instances"].max()),
        "instance_cap": cfg.instance_cap,
        "max_n_nonfinite": int(stacked["n_nonfinite"].max()),
        "n_active_before_refine": n_before,
        "n_active_after_refine": int(state.splats.n_active),
    }
    result["state"] = state  # for the caller's further checks and traces
    result["inputs"] = (cam, gt, bg, cfg)
    log(f"plain step {result['plain_ms']:.2f} ms, refine step {result['refine_ms']:.2f} ms, "
        f"amortised {result['amortized_ms']:.2f} ms -> {result['it_s']:.2f} it/s")
    return result


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_train needs an NVIDIA GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    print(f"card: {card()}", file=sys.stderr, flush=True)
    r = benchmark_train("cuda", log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps({
        "metric": METRIC,
        "value": round(r["it_s"], 3),
        "unit": "it/s",
        "vs_baseline": round(r["it_s"] / BASELINE_ITS, 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
