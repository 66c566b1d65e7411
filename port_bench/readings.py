"""Readings for the correctness limits, many seeds in one process: the
numbers the check compares for the program (`--side program`), for the
reference computed with TF32 on in the program's place (`--side control`)
or with a planted fault (`--side half`: the loss over half the image;
`--side pixel`: one frame pixel altered). One JSON line a seed. A
training cell's program side also gives the refine's numbers with each
fault of reference/mcmc.py::planted, put in the program's place
("refine_faults").

    python3 -m port_bench.readings --workload garden4-mcmc.train --side program --seeds 1 2 3

A training cell runs the set-up, the check's first steps and (on the
program side) the warm-up through its first refine, with no window; a
frame cell runs a one-second window.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control", "half", "pixel"), default="program")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from port_bench import run as bench_run

    import torch

    if not torch.cuda.is_available():
        print("error: no card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        extra = {}
        ctx = bench_run.cell_context(args.workload, seed, 1.0, False)
        drv = bench_run.driver(ctx)
        if ctx.traffic["driver"] == "train":
            out = ctx.cache / "runs" / "readings"
            trainer, first = drv.set_up(ctx, out, warm=args.side == "program")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            if args.side in ("control", "half"):
                first = drv.control_first(first, ctx, ctx.device, fault=
                                          "tf32" if args.side == "control" else "half")
            checks = drv.compare(first, ctx, ctx.device)
            if args.side == "program":
                checks += drv.compare_refine(first, ctx, ctx.device)
                extra["refine_faults"] = {
                    str(f): drv.refine_readings(first["refine"], ctx, ctx.device, f)
                    for f in (None, "skip", "uniform", "moments", "nosplit")}
            shutil.rmtree(out, ignore_errors=True)
        else:
            checks = drv.readings(ctx, args.side)
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "checks": {c.name: c.value for c in checks}, **extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
