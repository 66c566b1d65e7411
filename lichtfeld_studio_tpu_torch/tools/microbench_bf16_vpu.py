"""Microbenchmark T1 on one NVIDIA GPU (counterpart of
tools/microbench_bf16_vpu.py): does packed bf16 double the elementwise
rate of the CUDA cores against float32, what does a 128-deep log-step
prefix product cost by lane shuffles and by shared-memory shifts, and what
does bf16 buy the scan?

It decides whether the blend kernels' per-(instance, pixel) pipelines are
worth converting to bf16 pairs where the error budget allows, and which
shift mechanism a scan across the depth axis should use.

    python -m lichtfeld_studio_tpu_torch.tools.microbench_bf16_vpu

At G = 64 slabs of [128, 1024] (the original's grid: half the SMs) and at
G = 264 (two blocks on each of the 132 SMs) every kernel is first held
against its plain PyTorch version on the slabs it is timed on (float32 to
the bit, bf16 to the bit of each rounding, at 2 and at 64 repetitions),
then timed. The first line is the card's name and power limit.
"""

from __future__ import annotations

import sys

import torch

from lichtfeld_studio_tpu_torch.kernels import microbench as mb
from lichtfeld_studio_tpu_torch.profiling import device_ms

GRIDS = (64, 264)
VARIANTS = (
    ("elemwise f32 [128,1024] x4ops", "alu", dict(dtype="f32")),
    ("elemwise bf16x2 [128,1024] x4ops", "alu", dict(dtype="bf16")),
    ("scan f32 shared-memory shifts", "scan", dict(dtype="f32", impl="smem")),
    ("scan f32 lane shuffles", "scan", dict(dtype="f32", impl="shfl")),
    ("scan bf16x2 shared-memory shifts", "scan", dict(dtype="bf16", impl="smem")),
    ("scan bf16x2 lane shuffles", "scan", dict(dtype="bf16", impl="shfl")),
)


def slabs(g: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(0)
    return (torch.rand((g, mb.DEPTH, mb.WIDTH), generator=gen) * 0.01 + 0.99).to(device)


CHECK_REPS = (2, mb.REPS)  # at 64 the scans have underflowed to 0: 2 carries their check


def check(device, g: int, reps_list=CHECK_REPS) -> dict[str, float]:
    """Every variant against its plain version on G slabs (the grids that
    are timed); returns each variant's largest |kernel - plain| (0.0: equal
    to the bit) and raises beyond it. A scan's values must still be above 0
    after 2 repetitions, so that its comparison is not zeros against zeros."""
    x = slabs(g, device)
    worst = {}
    for name, kind, kw in VARIANTS:
        worst[name] = 0.0
        for reps in reps_list:
            if kind == "alu":
                k, p = mb.alu_elementwise(x, reps=reps, **kw), mb.alu_elementwise_plain(
                    x, reps=reps, dtype=kw["dtype"])
            else:
                k, p = mb.scan_prod(x, reps=reps, **kw), mb.scan_prod_plain(
                    x, reps=reps, dtype=kw["dtype"])
            torch.cuda.synchronize()
            err = float((k - p).abs().max())
            if not (torch.isfinite(k).all() and err == 0.0):
                raise RuntimeError(f"G={g} {name}, {reps} reps: max |kernel - plain| {err} "
                                   f"(expected 0)")
            if kind == "scan" and reps <= 2 and not float(k.min()) > 0.0:
                raise RuntimeError(f"G={g} {name}, {reps} reps: the values underflowed, the "
                                   f"comparison checks nothing")
            worst[name] = max(worst[name], err)
    return worst


def measure(device, g: int, reps: int = mb.REPS) -> dict[str, float]:
    """Milliseconds of each variant on G slabs."""
    x = slabs(g, device)
    out = {}
    for name, kind, kw in VARIANTS:
        fn = mb.alu_elementwise if kind == "alu" else mb.scan_prod
        out[name] = device_ms(lambda: fn(x, reps=reps, **kw))
    return out


def report(ms: dict[str, float], g: int, log=print) -> dict[str, float]:
    for name, t in ms.items():
        log(f"G={g:<4d}{name:36s}: {t:8.4f} ms total, {t / (g * mb.REPS) * 1e6:9.1f} ns per rep-block")
    e32, e16, s32m, s32s, s16m, s16s = ms.values()
    ratios = {"bf16_elemwise_speedup": e32 / e16, "shfl_vs_smem": s32m / s32s,
              "bf16_scan_speedup_shfl": s32s / s16s, "bf16_scan_speedup_smem": s32m / s16m}
    log(f"G={g:<4d}  bf16 elemwise speedup: {ratios['bf16_elemwise_speedup']:.2f}x   shuffles vs "
        f"shared memory: {ratios['shfl_vs_smem']:.2f}x   bf16 scan speedup: "
        f"{ratios['bf16_scan_speedup_shfl']:.2f}x (shuffles), "
        f"{ratios['bf16_scan_speedup_smem']:.2f}x (shared memory)")
    return ratios


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_bf16_vpu needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from lichtfeld_studio_tpu_torch.bench_train import card

    print(f"card: {card()}", flush=True)
    dev = torch.device("cuda")
    for g in GRIDS:
        worst = max(check(dev, g).values())
        print(f"G={g}: every variant equals its plain version at {CHECK_REPS} repetitions "
              f"(max |diff| {worst})", flush=True)
        report(measure(dev, g), g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
