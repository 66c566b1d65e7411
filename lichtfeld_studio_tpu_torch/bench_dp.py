"""The data-parallel MCMC train step at bench.py's geometry over N ranks
(parallel/data_parallel.py) on the GPUs of one host.

The train scene and configuration of tools/scenes.py (1M capacity, 600k
live gaussians, 1296x840, 32-px tiles, instance cap 1.4M); rank r renders
its camera turned 0.15 r rad about the world's y axis, against its own
random target (rank 0: the scene's). The ranks take the placement rule: rank r
on cuda:(r % device_count), NCCL when every rank has a card of its own,
gloo when they share one. Each rank runs `warmup` plain DP steps, then
`steps` more, each between two synchronises (host clock); then the reduce
alone (reduce_grads on one step's gradients, host clock between
synchronises) and, under NCCL, the bucket's all_reduce alone on the device
(CUDA events). The ranks must end with the same state bits.

    python -m lichtfeld_studio_tpu_torch.bench_dp [--ranks N] [--steps 10] [--warmup 3]

prints ONE JSON line (ranks, backend, step_ms and reduce_ms: medians on
rank 0; allreduce_device_ms; bucket_mb; views_per_s = ranks / step) and
the card's name and power limit on stderr. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import statistics
import sys
import time

import torch
import torch.distributed as dist

from lichtfeld_studio_tpu_torch.parallel.data_parallel import (
    broadcast_state,
    dp_train_step,
    reduce_grads,
    spawn_ranks,
    state_digest,
)
from lichtfeld_studio_tpu_torch.tools import scenes
from lichtfeld_studio_tpu_torch.train.state import StepFlags, compute_grads, init_train_state

VIEW_TURN = 0.15  # rad between the views of two consecutive ranks


def turned(cam, theta: float):
    """`cam` looking at the world turned by `theta` about its y axis: another
    view of the same scene for another rank."""
    c, s = math.cos(theta), math.sin(theta)
    rot = torch.tensor([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                       dtype=torch.float32, device=cam.w2c.device)
    w2c = cam.w2c @ rot
    return dataclasses.replace(cam, w2c=w2c, cam_position=-(w2c[:3, :3].T @ w2c[:3, 3]))


def rank_view(rank: int, cam, gt):
    """Rank `rank`'s camera and target: the train scene's for rank 0, else the
    camera turned VIEW_TURN * rank and a random target seeded with the rank."""
    if rank == 0:
        return cam, gt
    gen = torch.Generator(device=gt.device).manual_seed(rank)
    return (dataclasses.replace(turned(cam, VIEW_TURN * rank), uid=rank),
            torch.rand(gt.shape, generator=gen, device=gt.device))


def _bench_rank(ctx, warmup: int, steps: int, sizes: dict) -> dict:
    dev = ctx.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def host_ms(fn) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return 1e3 * (time.perf_counter() - t0)

    sd, cam, gt, bg, cfg, lrs = scenes.train_scene(dev, **sizes)
    state = init_train_state(sd, lrs, seed=0)
    broadcast_state(state, ctx)
    cam, gt = rank_view(ctx.rank, cam, gt)
    out = {"step_ms": []}

    def one_step():
        nonlocal state
        state, m = dp_train_step(state, cam, gt, bg, cfg, StepFlags(), ctx.group)
        out["loss"] = m["loss"]

    for i in range(warmup + steps):
        ms = host_ms(one_step)
        if i >= warmup:
            out["step_ms"].append(ms)
    out["loss"] = float(out["loss"])
    grads = compute_grads(state, cam, gt, bg, cfg)[2]
    out["reduce_ms"] = [host_ms(lambda: reduce_grads(grads, ctx.group)) for _ in range(steps)]
    bucket = torch.cat([g.reshape(-1) for k, g in grads.items() if k[0] != "_"])
    out["bucket_mb"] = bucket.numel() * 4 / 1e6
    out["allreduce_device_ms"] = None
    if ctx.backend == "nccl":
        from lichtfeld_studio_tpu_torch.profiling import device_ms

        out["allreduce_device_ms"] = device_ms(lambda: dist.all_reduce(bucket, group=ctx.group))
    out["digest"] = state_digest(state)
    return out


def benchmark_dp(ranks: int, device="cuda", *, warmup: int = 3, steps: int = 10,
                 **sizes) -> dict:
    """Time the DP step over `ranks` ranks (the module's protocol);
    `sizes` overrides the train scene's sizes (small scenes for tests). Raises
    unless the ranks end with the same state."""
    res = spawn_ranks(_bench_rank, ranks, args=(warmup, steps, sizes), device=device,
                      timeout=datetime.timedelta(minutes=10), deadline=1800.0)
    if len({r["digest"] for r in res}) != 1:
        raise RuntimeError(f"the {ranks} ranks ended with different states")
    r0 = res[0]
    step_ms = statistics.median(r0["step_ms"])
    return {
        "ranks": ranks,
        "backend": "nccl" if r0["allreduce_device_ms"] is not None else "gloo",
        "step_ms": step_ms,
        "reduce_ms": statistics.median(r0["reduce_ms"]),
        "allreduce_device_ms": r0["allreduce_device_ms"],
        "bucket_mb": r0["bucket_mb"],
        "views_per_s": 1e3 * ranks / step_ms,
        "loss": r0["loss"],
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="bench_dp", description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=None, help="default: one a card")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_dp needs an NVIDIA GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    print(f"card: {scenes.card()} x {torch.cuda.device_count()}", file=sys.stderr, flush=True)
    r = benchmark_dp(args.ranks or torch.cuda.device_count(), warmup=args.warmup, steps=args.steps)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
