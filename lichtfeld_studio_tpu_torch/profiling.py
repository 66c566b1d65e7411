"""Stage ranges of the render and the train step, what a torch.profiler
trace of them says (device events, busy share, device time per stage), and
the host spans the same ranges record on demand.

`rasterize`, `compute_grads`, `apply_update` and the blend's backward run
each stage inside `stage(name)`, a profiler range "lfs.<name>"; the
trainer's loop (`dispatch`, `step`, `loader_wait`, `h2d`, `backward`,
`readback`) and the headless frame (`frame`) do too. A trace links each
device kernel, copy and fill to the host op that launched it;
`stage_device_ms` counts it toward the innermost range around that op
inside its autograd node, if any, and the backward's kernels, which run
in autograd nodes outside every stage, toward "<stage> bwd", the stage
whose forward op made the node.

Trace with `device_trace()`: a profiler started right before the work
can lose the device events of the first launches after it starts
(`lost_device_events` counts them), and with them the first stage's time.

Host spans. Inside `record_spans()` every `stage(name)` also appends a
span to the record the context yields, with no profiler running or under
one. After the body ends, `record.spans` is a list of `Span(name, start,
end, thread, parent, unit)` in the order the spans opened:
- `start`, `end`: integer nanoseconds on the profiler's clock (the epoch
  clock of `time.time_ns()`, which torch.profiler stamps its events with),
  so a span lines up with a trace's events as it is. The spans are timed
  by `time.perf_counter_ns()` and put on that clock by one anchor pair of
  the two clocks read when the record opened; a span still open when the
  body ends ends there.
- `thread`: the id of the thread the span ran on (`threading.get_ident()`).
- `parent`: the index of the innermost span open on the same thread when
  this one opened; on a thread with none open (autograd's device thread,
  which runs the blend's backward), the innermost open on the recording
  thread, the one that opened the record; -1 for none.
- `unit`: the trainer iteration or frame the span belongs to: the
  `unit` given to `stage`, else its parent's, else (a span with neither)
  its own index.
`record.start` and `record.end` are the body's ends on the same clock and
`record.thread` the recording thread's id. Outside `record_spans()`
`stage()` is the profiler range alone; inside, a span costs a few list
operations, a thread id and two clock reads, and nothing is written
anywhere. A profiler may start or stop while no stage is open (the
trainer's live control runs outside every stage): torch asserts when a
range entered with no profiler running exits under one.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

STAGE_PREFIX = "lfs."
_BACKWARD = "autograd::engine::evaluate_function"


_record = None  # the open SpanRecord, or None


def stage(name: str, unit: int | None = None):
    """Profiler range "lfs.<name>" around a stage. It is recorded as a
    function, not as a user annotation, so that a kernel launched inside it
    with no aten op around the launch (the ctypes kernels of kernels/) is
    linked to the range in a trace: a user annotation takes no kernels.
    Inside `record_spans()` it also records a host span (`unit`: the
    iteration or frame it starts, see the module docstring)."""
    rng = torch._C._profiler._RecordFunctionFast(STAGE_PREFIX + name)
    return rng if _record is None else _OpenSpan(_record, name, unit, rng)


class Span(NamedTuple):
    name: str
    start: int
    end: int
    thread: int
    parent: int
    unit: int


class SpanRecord:
    """The spans of one `record_spans()` body (see the module docstring).
    While the body runs, each span is a list [name, start, end, thread,
    parent's list or None, unit or the list that starts the unit] on the
    perf_counter clock."""

    def __init__(self):
        best = None
        for _ in range(5):  # the anchor: the pair of reads closest together
            a, wall, b = time.perf_counter_ns(), time.time_ns(), time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, wall - (a + b) // 2)
        self._shift = best[1]  # perf_counter_ns -> the profiler's clock
        self.start, self.end = time.perf_counter_ns(), 0
        self.thread = threading.get_ident()
        self.spans: list = []
        self._stacks: dict[int, list] = {self.thread: []}  # open spans by thread

    def _finish(self) -> None:
        """Index the parents and put every time on the profiler's clock."""
        end, shift, entries = time.perf_counter_ns(), self._shift, list(self.spans)
        index = {id(s): i for i, s in enumerate(entries)}
        spans = []
        for name, t0, t1, tid, parent, unit in entries:
            spans.append(Span(name, t0 + shift, (t1 or end) + shift, tid,
                              -1 if parent is None else index[id(parent)],
                              unit if isinstance(unit, int) else index[id(unit)]))
        self.spans = spans
        self.start, self.end = self.start + shift, end + shift


class _OpenSpan:
    __slots__ = ("record", "name", "unit", "range", "entry", "stack")

    def __init__(self, record: SpanRecord, name: str, unit: int | None, rng):
        self.record, self.name, self.unit, self.range = record, name, unit, rng

    def __enter__(self):
        self.range.__enter__()
        rec, tid = self.record, threading.get_ident()
        stack = rec._stacks.get(tid)
        if stack is None:
            stack = rec._stacks[tid] = []
        # a slice, not an index: another thread may pop its last span meanwhile
        parent = (stack or rec._stacks[rec.thread][-1:] or [None])[-1]
        self.entry = [self.name, 0, 0, tid, parent, self.unit]
        if self.unit is None:
            self.entry[5] = self.entry if parent is None else parent[5]
        rec.spans.append(self.entry)
        stack.append(self.entry)
        self.stack = stack
        self.entry[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.entry[2] = time.perf_counter_ns()
        self.stack.pop()
        return self.range.__exit__(*exc)


@contextlib.contextmanager
def record_spans():
    """Record a host span for every `stage()` the body runs, on any
    thread; yields the SpanRecord, whose spans are ready when the body
    ends (see the module docstring)."""
    global _record
    if _record is not None:
        raise RuntimeError("record_spans() is already recording")
    rec = _record = SpanRecord()
    try:
        yield rec
    finally:
        _record = None
        rec._finish()


LEAD_IN = 32  # launches of device_trace's lead-in
SETTLE_S = 0.1  # seconds from the kept cycle's start to the body


@contextlib.contextmanager
def device_trace(device="cuda"):
    """torch.profiler (host ops, and device events on a GPU) over the body;
    yields the profile, read it after the block. A trace started right
    before the work loses device events in two ways, both measured on an
    H100 with `lost_device_events`: the first few launches after the
    profiler turns device tracing on have none, and the device's clock can
    read milliseconds behind the host's, which drops every event that
    then reads before the trace's start. So the profiler turns tracing on
    a cycle early, on a lead-in of LEAD_IN small launches that it does not
    keep, and the body starts SETTLE_S into the kept cycle."""
    gpu = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if gpu else [])

    def sync():
        if gpu:
            torch.cuda.synchronize(device)

    with torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(
            wait=0, warmup=1, active=1)) as prof:
        x = torch.zeros(64, device=device)
        for _ in range(LEAD_IN):
            x.add_(1.0)
        sync()
        prof.step()
        time.sleep(SETTLE_S)
        yield prof
        sync()


def device_events(prof: torch.profiler.profile) -> list:
    """The device's kernels, copies and fills of a trace, without the
    profiler's own step annotation on the device."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]


def _union_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def device_summary(prof: torch.profiler.profile, top: int = 12) -> dict | None:
    """The device events of a profiled run (None if it holds none): their
    count, how many are copies or fills, their summed and busy (union)
    microseconds, the span from the first to the last, and the `top`
    kernels by time as (name, launches, us)."""
    events = device_events(prof)
    if not events:
        return None
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    by_name: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in events:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    return {
        "events": len(events),
        "copies": sum(1 for e in events if "memcpy" in e.name.lower() or "memset" in e.name.lower()),
        "summed_us": sum(e - s for s, e in spans),
        "busy_us": _union_us(spans),
        "span_us": max(e for _, e in spans) - min(s for s, _ in spans),
        "top": [(name, n, us) for name, (n, us) in
                sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]],
    }


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def _stage_name(chain) -> str | None:
    return next((a.name[len(STAGE_PREFIX):] for a in chain if a.name.startswith(STAGE_PREFIX)),
                None)


def stage_times(events, time_of) -> dict[str, float]:
    """Sum time_of(event) over host events by stage: the innermost stage
    range around the event (the event itself included) inside the autograd
    node it runs in, if any; else, for work of the backward, "<stage>
    bwd"; else "other". Ranges around a node (`backward`, `step`: the
    backward runs inside them where autograd runs it on the calling
    thread, as on the CPU) do not name its work. An autograd node carries
    its forward thread and a sequence number that every op on that thread
    records until the node exists: the last of them made the node."""
    seq_stage = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.sequence_nr < 0:
            continue
        chain = []
        for a in _ancestors(e):
            if a.name.startswith(_BACKWARD):
                break
            chain.append(a)
        else:
            seq_stage[(e.thread, e.sequence_nr)] = _stage_name(chain)
    out: dict[str, float] = defaultdict(float)
    for e in events:
        t = time_of(e)
        if not t:
            continue
        chain = []
        for a in _ancestors(e):
            chain.append(a)
            if a.name.startswith(_BACKWARD):
                break
        name = _stage_name(chain)
        if name is None:
            node = chain[-1] if chain[-1].name.startswith(_BACKWARD) else None
            fwd = (seq_stage.get((node.fwd_thread, node.sequence_nr))
                   if node is not None else None)
            name = f"{fwd} bwd" if fwd else "other"
        out[name] += t
    return dict(out)


def stage_device_ms(prof: torch.profiler.profile) -> dict[str, float]:
    """Device milliseconds of each stage (stage_times) of a profiled run."""
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    us = stage_times(cpu, lambda e: sum(k.duration for k in e.kernels))
    return {k: v / 1e3 for k, v in us.items()}


_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


def lost_device_events(prof: torch.profiler.profile) -> dict:
    """What a trace lost between the host and the device: `missing`, the
    launch calls (kernels, async copies and fills) of the trace with no
    device event of their own, and the host ops of the first few of them
    (`ops`); `lead_us`, the least (device event - its launch call) over the
    launches, negative when the device's clock reads behind the host's (nan
    without a launch on the device)."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    names = {e.correlation_id(): e.name() for e in events
             if e.device_type() == cpu and e.linked_correlation_id() == 0}
    launches = {e.correlation_id(): e for e in events
                if e.device_type() == cpu and e.name() in _LAUNCH_CALLS}
    device: dict[int, int] = {}
    for e in events:
        if e.device_type() == cuda and not e.name().startswith("ProfilerStep"):
            c = e.correlation_id()
            device[c] = min(device.get(c, e.start_ns()), e.start_ns())
    lost = sorted((e.start_ns(), c) for c, e in launches.items() if c not in device)
    leads = [(device[c] - e.start_ns()) / 1e3 for c, e in launches.items() if c in device]
    return {"launches": len(launches), "missing": len(lost),
            "ops": [names.get(launches[c].linked_correlation_id(), "?") for _, c in lost[:4]],
            "lead_us": min(leads) if leads else float("nan")}


def device_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls,
    between two CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
