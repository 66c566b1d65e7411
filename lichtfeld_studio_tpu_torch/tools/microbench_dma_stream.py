"""Microbenchmark T2 on one NVIDIA GPU (counterpart of
tools/microbench_dma_stream.py): what a chunk of the blend kernels' batch
loads costs when it streams from device memory into shared memory through
a 4-slot cp.async ring, as strided row segments or as one contiguous block.

Layouts (rows x width of f32, a chunk = `rows` segments of 4 * width bytes):
  row8:   [8, 128]    eight 512-byte segments (feature-major rows)
  blk:    [1, 1024]   the same 4 KB in one piece (instance-major block)
  row8x4: [8, 512]    four chunks a copy, strided
  blk_x4: [1, 4096]   four chunks a copy, contiguous
  row2:   [2, 128], row16: [16, 128]

    python -m lichtfeld_studio_tpu_torch.tools.microbench_dma_stream

Each layout runs with ONE block (what a single block can pull, 8192 chunks
of 4 KB: 32 MB, which the 50 MB L2 holds after the first pass) and with a
grid of 264 blocks over 8 times as many chunks (256 MB, beyond L2: device
memory). torch.clone of the same bytes is the library yardstick. The first
line is the card's name and power limit.
"""

from __future__ import annotations

import sys

import torch

from lichtfeld_studio_tpu_torch.kernels import microbench as mb
from lichtfeld_studio_tpu_torch.profiling import device_ms

CHUNKW = 128
NB = 8192  # chunks streamed by the single block
GRID = 264  # two blocks an SM
GRID_SCALE = 8  # the grid streams this many times the chunks
LAYOUTS = (  # label, rows, width, chunks
    ("row8", 8, CHUNKW, NB),
    ("blk", 1, 8 * CHUNKW, NB),
    ("row8x4", 8, 4 * CHUNKW, NB // 4),
    ("blk_x4", 1, 32 * CHUNKW, NB // 4),
    ("row2", 2, CHUNKW, NB),
    ("row16", 16, CHUNKW, NB),
)
CHECK_REL = 1e-5  # of the sum of |values|: float32 adds in another order


def make(rows: int, width: int, nb: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((rows, nb * width), generator=gen, device=device)


def check(x: torch.Tensor, width: int, blocks: int) -> float:
    """Kernel against plain version; returns the error relative to the sum
    of |values| and raises beyond CHECK_REL."""
    k = mb.stream_ring(x, width=width, blocks=blocks)
    p = mb.stream_ring_plain(x, width=width, blocks=blocks)
    torch.cuda.synchronize()
    rel = float((k - p).abs().max() / x[0, ::width].abs().sum() * blocks)
    if not (torch.isfinite(k).all() and rel <= CHECK_REL):
        raise RuntimeError(f"stream_ring [{x.shape[0]}, {width}] x{blocks} blocks: relative "
                           f"error {rel} > {CHECK_REL}")
    return rel


def measure(device, label: str, rows: int, width: int, nb: int, blocks: int) -> dict:
    x = make(rows, width, nb, device)
    rel = check(x, width, blocks)
    ms = device_ms(lambda: mb.stream_ring(x, width=width, blocks=blocks), reps=5)
    clone_ms = device_ms(lambda: x.clone(), reps=5)
    nbytes = x.numel() * 4
    return {"label": label, "rows": rows, "width": width, "chunks": nb, "blocks": blocks,
            "bytes": nbytes, "ms": ms, "us_per_chunk": 1e3 * ms / nb, "gb_s": nbytes / ms / 1e6,
            "clone_ms": clone_ms, "rel_err": rel}


def report(r: dict, log=print) -> None:
    log(f"{r['label']:8s} x{r['blocks']:<4d}: {r['ms']:8.3f} ms for {r['chunks']} chunks of "
        f"[{r['rows']},{r['width']}] -> {r['us_per_chunk']:7.4f} us/chunk, {r['gb_s']:8.1f} GB/s "
        f"(torch.clone of the same bytes {r['clone_ms']:.3f} ms)")


def run_all(device, log=print) -> list[dict]:
    results = []
    for label, rows, width, nb in LAYOUTS:
        for blocks, scale in ((1, 1), (GRID, GRID_SCALE)):
            r = measure(device, label, rows, width, nb * scale, blocks)
            report(r, log)
            results.append(r)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_dma_stream needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from lichtfeld_studio_tpu_torch.tools.scenes import card

    print(f"card: {card()}", flush=True)
    r = {(x["label"], x["blocks"]): x for x in run_all(torch.device("cuda"))}
    for blocks in (1, GRID):
        print(f"x{blocks}: row8 / blk time per chunk: "
              f"{r['row8', blocks]['us_per_chunk'] / r['blk', blocks]['us_per_chunk']:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
