"""Run one benchmark cell: `python3 -m port_bench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>` from the root of a checkout.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by the names in BENCHMARK.json:
`configs/<config>.json`, `traffic/<traffic>.json` (its "driver" names
`drivers/<driver>.py`), `metrics/<metric>.py` (a reader returning the
metric or None) and `limits/<cell>.json` (the correctness limits). The
driver sets up (counted in setup_s), measures for --seconds, and hands back
what it measured and the numbers its correctness check compared.

The last line of standard output is the result as one JSON object; the
numbers compared and their limits are also the last lines of standard
error. A run that finds no card, fewer cards than the cell asks for, or
JAX or the JAX package loaded, prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lichtfeld_studio_tpu")

from port_bench.harness import CACHE, HERE, ROOT, Context, Result  # noqa: E402


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_context(name: str, seed: int, seconds: float, trace: bool, spec: dict | None = None,
                 base: Path = HERE, **kw) -> Context:
    """The cell's configuration, traffic and limits, by the names in
    BENCHMARK.json (or in `spec`, a dict of the same layout, with its
    files under `base`)."""
    spec = spec or bench()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return Context(cell=cell, config=load_json(ROOT / cfg_entry["file"]),
                   traffic=load_json(base / "traffic" / f"{cell['traffic']}.json"),
                   limits=load_json(base / "limits" / f"{name}.json"),
                   seed=seed, seconds=seconds, trace=trace, base=base, **kw)


def driver(ctx: Context):
    return load_module(ctx.base / "drivers" / f"{ctx.traffic['driver']}.py",
                       f"port_bench_driver_{ctx.traffic['driver']}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_per_layer(spec: dict, cell: str, readings: dict, base: Path = HERE) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in spec["per_layer"]:
        if not applies(m, cell):
            continue
        value = load_module(base / "metrics" / f"{m['name']}.py",
                            "port_bench_metric_" + m["name"].replace(".", "_")).read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def result_line(spec: dict, ctx: Context, res: Result, setup_s: float, device: dict) -> dict:
    if ctx.trace:
        metrics = read_per_layer(spec, ctx.cell["name"], res.readings, ctx.base)
    else:
        values = dict(res.metrics, setup_s=setup_s, peak_mem_gib=res.memory_peak_bytes / 2 ** 30)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if applies(m, ctx.cell["name"])}
    line = {"correct": all(c.ok for c in res.checks) and bool(res.checks),
            "attempted": res.attempted, "failed": res.failed, "metrics": metrics,
            "device": device}
    if ctx.trace and res.trace is not None:
        line["breakdown"] = res.trace["breakdown"]
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in res.checks}
    return line


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    spec = bench()
    ctx = cell_context(args.workload, args.seed, args.seconds, bool(args.trace), spec)

    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false: this benchmark measures the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < ctx.cell["chips"]:
        print(f"error: the cell asks for {ctx.cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    res = driver(ctx).run(ctx)
    if ctx.window_start is None:
        raise RuntimeError("the driver never started its window")
    setup_s = ctx.window_start - T_START
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {found} (the JAX package or JAX): the benchmark "
              "measures the PyTorch port alone", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": ctx.cell["chips"], "memory_peak_bytes": res.memory_peak_bytes}
    if ctx.trace:
        device.update(busy_s=res.trace["busy_s"], window_s=res.trace["window_s"])
    line = result_line(spec, ctx, res, setup_s, device)
    for c in res.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
