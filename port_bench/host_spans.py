"""Run one cell's traced run with the program's host spans: `python3 -m
port_bench.host_spans --workload <cell> --seed <n>` from the root of a
checkout, on the card.

A traced run (`port_bench.run --trace 1`) times an untraced stretch, then
profiles the device alone and then the host's ops. This runs the cell's
own driver with two stretches more right after its untraced one, before
its profiles slow the host (host_spans.json holds their metrics in
BENCHMARK.json's form; no cell's driver runs the stretches yet):
- the spans stretch: `untraced_iterations` iterations (`untraced_frames`
  frames) inside profiling.record_spans() and no profiler;
- the attribution stretch: `busy_iterations` (`busy_frames`) inside
  record_spans() inside a device-only trace.device_trace(host=False).
Training takes them in the train driver's Window; frames in the view
driver's run, from its first device_trace, with the frames it issued.
What recording costs, `recording_cost_pct`: the spans a unit of the
spans stretch times what an empty `stage()` costs on this host with
recording on over off (`span_us`, timed here), over its wall ms a unit.
The reductions (spans.py) of the two go into the readings as "spans"
("host", "idle"), and the metrics of host_spans.json are read from them.

The last line of standard output is one JSON object: the cell's traced
metrics and the span metrics, the two reductions, and the numbers that
check them: the wall ms a unit of the driver's untraced stretch
(`plain_wall_ms`), of the spans stretch (`wall_ms`) and of the
attribution stretch (`idle_wall_ms`); the attribution stretch's idle a
unit from the span split (`idle_split_ms`) against 1 - busy / wall
(trace.busy, `idle_busy_ms`); the idle the span metrics divide
(`idle_ms`, the spans stretch's wall less the attribution stretch's busy,
a unit); for training, the stage attribution of the host-op profile with
and without the spans' ranges (spans.moved_stages) and the median host
ms a step in run_dispatch.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
import timeit

from port_bench import run as bench_run
from port_bench.harness import HERE, sync
from port_bench.spans import device_intervals, moved_stages, reduce
from port_bench.trace import busy

# (name, inside a device-only profile, its length in the traffic's params)
TRAIN_STRETCHES = (("host", False, "untraced_iterations"), ("idle", True, "busy_iterations"))


def as_record(rec) -> dict:
    """A profiling.SpanRecord as spans.py reads it."""
    return {"start": rec.start, "end": rec.end, "thread": rec.thread,
            "spans": [list(s) for s in rec.spans]}


def reductions(host, idle, unit: str) -> dict:
    """spans.py's reductions of the two stretches: `host` a SpanRecord,
    `idle` (SpanRecord, profile). The attribution stretch's also gives
    `idle_from_busy_ms`, its idle a unit as 1 - busy / wall (trace.busy),
    to check the split against."""
    rec, prof = idle
    wall_s = (rec.end - rec.start) / 1e9
    busy_s = busy(prof, wall_s)["busy_s"]  # parses the trace: before its kineto events are read
    out = {"host": reduce(as_record(host), unit),
           "idle": reduce(as_record(rec), unit, *device_intervals(prof))}
    out["idle"]["idle_from_busy_ms"] = 1e3 * (wall_s - busy_s) / out["idle"]["units"]
    return out


def span_window(base):
    """The train driver's Window, with the stretches of TRAIN_STRETCHES
    between its untraced stretch and its device-only profile."""
    from lichtfeld_studio_tpu_torch.profiling import record_spans

    class SpansWindow(base):
        made: list = []

        def __init__(self, ctx):
            super().__init__(ctx)
            self.made.append(self)
            self.done = {}  # stretch -> (SpanRecord, profile or None)
            self._it = None  # the iteration the open stretch began at

        def _open(self, host: bool) -> None:
            if host or len(self.done) == len(TRAIN_STRETCHES):
                super()._open(host)
            # else the device-only profile waits: run_pending opens it after the stretches

        def _begin(self, it: int) -> None:
            _, device, _ = TRAIN_STRETCHES[len(self.done)]
            if device:
                super()._open(host=False)
            self._cm = record_spans()
            self._rec = self._cm.__enter__()
            self._it = it

        def run_pending(self, trainer) -> None:
            if self.stop_requested:
                return
            it = trainer.last_progress[0]
            if self.plain is None or len(self.done) == len(TRAIN_STRETCHES):
                super().run_pending(trainer)
                if self.plain is not None and self._it is None:
                    self._begin(it)  # the untraced stretch has just ended
                return
            name, device, length = TRAIN_STRETCHES[len(self.done)]
            if it - self._it < self.tr[length]:
                return
            sync(self.ctx.device)
            self._cm.__exit__(None, None, None)
            self.done[name] = (self._rec, self._close() if device else None)
            if len(self.done) < len(TRAIN_STRETCHES):
                self._begin(it)
                return
            super()._open(host=False)  # the driver's own stretches go on
            self.t_busy, self.it_busy = time.perf_counter(), it

    return SpansWindow


def run_train(ctx) -> dict:
    import torch

    drv = bench_run.driver(ctx)
    window_cls = drv.Window = span_window(drv.Window)
    res = drv.run(ctx)
    w = window_cls.made[-1]
    host_s = [s / k for k, s in w.enqueue_s if k > 1]
    cpu = [e for e in w.stage[0].events() if e.device_type == torch.autograd.DeviceType.CPU]
    return {"res": res, "spans": reductions(w.done["host"][0], w.done["idle"], "step"),
            "enqueue_ms_median": 1e3 * statistics.median(host_s) if host_s else None,
            "moved": moved_stages(cpu)["changed"]}


def run_view(ctx) -> dict:
    """The view driver's run, its first device_trace preceded by the two
    stretches, which issue the frames the driver issued before it."""
    from lichtfeld_studio_tpu_torch.profiling import record_spans
    from lichtfeld_studio_tpu_torch.render import headless
    from port_bench import trace

    drv = bench_run.driver(ctx)
    tr = ctx.traffic["params"]
    frame, device_trace = headless.render_frame_u8, trace.device_trace
    calls, done = {}, {}

    def seen_frame(splats, params, *args):
        if not done:
            calls.setdefault(id(params), (splats, params, args))
        return frame(splats, params, *args)

    def frames(count: int) -> None:
        todo = list(calls.values())
        for k in range(count):
            splats, params, args = todo[k % len(todo)]
            frame(splats, params, *args)[0].cpu().numpy()
        sync(ctx.device)

    @contextlib.contextmanager
    def stretches_first(host: bool = True):
        if not done:
            with record_spans() as rec:
                frames(tr["untraced_frames"])
            with device_trace(host=False) as prof:
                with record_spans() as idle:
                    frames(tr["busy_frames"])
            done.update(host=rec, idle=(idle, prof))
            calls.clear()
        with device_trace(host) as prof:
            yield prof

    headless.render_frame_u8, trace.device_trace = seen_frame, stretches_first
    try:
        res = drv.run(ctx)
    finally:
        headless.render_frame_u8, trace.device_trace = frame, device_trace
    return {"res": res, "spans": reductions(done["host"], done["idle"], "frame")}


def span_cost_us(reps: int = 100_000) -> tuple[float, float]:
    """Host us of an empty `stage()` with recording off, and on."""
    from lichtfeld_studio_tpu_torch.profiling import record_spans, stage

    def one():
        with stage("cost"):
            pass

    off = timeit.timeit(one, number=reps)
    with record_spans():
        on = timeit.timeit(one, number=reps)
    return 1e6 * off / reps, 1e6 * on / reps


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no card: the spans are read against the card's trace", file=sys.stderr)
        return 2
    spec = bench_run.bench()
    ctx = bench_run.cell_context(args.workload, args.seed, args.seconds, True, spec)
    out = run_train(ctx) if ctx.traffic["driver"] == "train" else run_view(ctx)
    res, sp = out["res"], out["spans"]
    rd = dict(res.readings, spans=sp)
    cell = ctx.cell["name"]
    metrics = bench_run.read_per_layer(spec, cell, rd)
    spans_spec = bench_run.load_json(HERE / "host_spans.json")
    metrics.update(bench_run.read_per_layer(spans_spec, cell, rd))
    host, idle = sp["host"], sp["idle"]
    span_us = span_cost_us()
    wall_ms = 1e3 * host["wall_s"] / host["units"]
    line = {
        "workload": cell, "seed": args.seed, "device": torch.cuda.get_device_name(0),
        "metrics": metrics, "spans": sp,
        "plain_wall_ms": 1e3 * res.trace["plain_s"] / res.trace["plain_units"],
        "wall_ms": wall_ms,
        "idle_wall_ms": 1e3 * idle["wall_s"] / idle["units"],
        "idle_split_ms": idle["idle_total_ms"],
        "idle_busy_ms": idle["idle_from_busy_ms"],
        "idle_ms": wall_ms - idle["busy_ms"],
        "span_us": {"off": span_us[0], "on": span_us[1],
                    "spans_per_unit": host["spans"] / host["units"]},
        "recording_cost_pct": (100 * host["spans"] / host["units"] * (span_us[1] - span_us[0])
                               / 1e3 / wall_ms),
        "checks": {c.name: {"value": c.value, "limit": c.limit} for c in res.checks},
        "correct": all(c.ok for c in res.checks),
    }
    for key in ("enqueue_ms_median", "moved"):
        if key in out:
            line[key] = out[key]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
