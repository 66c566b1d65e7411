"""Microbenchmark T3 on one NVIDIA GPU (counterpart of
tools/microbench_scan_orient.py): should a blend walk a tile's depth axis
across the lanes of a warp (log-step shuffle scans, a warp a pixel) or
serially inside the thread that owns the pixel (how the blend kernels walk
today)?

Both run 64 repetitions of (prefix product + prefix sum + the elementwise
passes between them) over 128 depth values a pixel, on G slabs of 1024
pixels: G = 64 (the original's grid) and G = 528.

    python -m lichtfeld_studio_tpu_torch.tools.microbench_scan_orient

Each is first held, on the slabs it is timed on, against its plain PyTorch
version: the log-step scans
for the lanes form (to the bit), torch.cumprod / torch.cumsum for the
serial form (the card's cumsum adds in another order: 1e-5 of the largest
value). The first line is the card's name and power limit.
"""

from __future__ import annotations

import sys

import torch

from lichtfeld_studio_tpu_torch.kernels import microbench as mb
from lichtfeld_studio_tpu_torch.profiling import device_ms

GRIDS = (64, 528)
PIXELS = 1024
CHECK_REL = {"lanes": 0.0, "thread": 1e-5}


def slabs(g: int, orient: str, device) -> torch.Tensor:
    """The same values in both orientations: [G, 128, P] for "thread", its
    transpose [G, P, 128] for "lanes"."""
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((g, mb.DEPTH, PIXELS), generator=gen) * 0.8 + 0.1
    if orient == "lanes":
        x = x.transpose(1, 2).contiguous()
    return x.to(device)


def check(device, orient: str, g: int, reps: int = mb.REPS) -> float:
    """Kernel against plain version on G slabs (the grids that are timed);
    the error relative to the largest plain value, of the output and of the
    final x; raises beyond CHECK_REL[orient]."""
    x = slabs(g, orient, device)
    out_k, x_k = mb.scan_orient(x, orient=orient, reps=reps)
    out_p, x_p = mb.scan_orient_plain(x, orient=orient, reps=reps)
    torch.cuda.synchronize()
    rel = max(float((out_k - out_p).abs().max() / out_p.abs().max()),
              float((x_k - x_p).abs().max() / x_p.abs().max()))
    if not (torch.isfinite(out_k).all() and torch.isfinite(x_k).all()
            and rel <= CHECK_REL[orient]):
        raise RuntimeError(f"scan_orient {orient}, G={g}: relative error {rel} > {CHECK_REL[orient]}")
    return rel


def measure(device, g: int, reps: int = mb.REPS) -> dict[str, float]:
    out = {}
    for orient in ("thread", "lanes"):
        x = slabs(g, orient, device)
        out[orient] = device_ms(lambda: mb.scan_orient(x, orient=orient, reps=reps))
    return out


def report(ms: dict[str, float], g: int, log=print) -> float:
    what = {"thread": "serial in a thread, [128, 1024]", "lanes": "across lanes, [1024, 128]"}
    for orient, t in ms.items():
        log(f"G={g:<4d}{what[orient]:34s}: {t:8.4f} ms total, "
            f"{t / (g * mb.REPS) * 1e3:8.3f} us per (prod+sum) scan pair of a slab")
    ratio = ms["thread"] / ms["lanes"]
    log(f"G={g:<4d}  lanes speedup over serial: {ratio:.2f}x")
    return ratio


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_scan_orient needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from lichtfeld_studio_tpu_torch.bench_train import card

    print(f"card: {card()}", flush=True)
    dev = torch.device("cuda")
    for g in GRIDS:
        for orient in ("lanes", "thread"):
            print(f"G={g} {orient}: relative error against the plain version "
                  f"{check(dev, orient, g):.3g} <= {CHECK_REL[orient]}", flush=True)
        report(measure(dev, g), g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
