"""The reduction of the program's host spans (profiling.record_spans) to
the benchmark's numbers: host ms a unit by span name, in total and as self
time, and the device's idle ms a unit split by the span the host was in.

A record is a dict: "start" and "end" of the recorded stretch and "spans",
each [name, start, end, thread, parent, unit] (parent: an index into
"spans" or -1), all times integer ns on the profiler's clock, and "thread",
the thread that recorded (the trainer's or the viewer's loop). A unit is
an iteration (the `step` spans) or a frame (the `frame` spans).

Totals count a span only where no span of the same name encloses it. Self
time is a span's duration less the part of it that its child spans, on
any thread, cover. Idle time is the part of the stretch in which no device
event runs, each piece of it put to the innermost span then open on the
recording thread ("none" where none is): `idle_self_ms` by that span's
name, `idle_ms` by the name of each span open around it (a name once).

The span readers in metrics/ read a run's readings["spans"]: "host", the
reduction of the spans stretch (spans, no profiler), and "idle", that of
the attribution stretch (spans inside a device-only profile), through
host_ms, wall_ms and idle_ms below, and return None where a stretch or
span is missing. The profiler slows the host's launches, and on a
host-led step each slower launch widens the device's idle: the
attribution stretch gives only the split of its idle, as shares, and the
device's busy time a unit. The idle a unit those shares divide is the
spans stretch's wall less that busy time.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from port_bench.trace import STAGE_PREFIX, stage_device_us

NONE = "none"
# the program's host spans around the stages (profiling.stage ranges too)
HOST_SPANS = ("dispatch", "step", "loader_wait", "h2d", "backward", "readback", "frame")
_BACKWARD = "autograd::engine::evaluate_function"
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaMemcpyAsync", "cudaMemsetAsync")
# the lead taken for the host-device offset: this low quantile of the leads
# (device start - its launch call), not the least, which one launch matched
# to the wrong device event would set
OFFSET_QUANTILE = 0.001
# the device's clock drifts against the host's within a trace (48 us over
# 100 iterations on an H100), so the launches, in launch order, fall into
# windows of at least WINDOW_LEADS, at most OFFSET_WINDOWS of them, each
# with its offset, put at its middle launch and interpolated between
WINDOW_LEADS = 1000
OFFSET_WINDOWS = 16
# neighbouring windows' offsets may differ by this much; further apart, the
# device's clock stepped, no offset puts its events beside the host's
# spans, and the idle is not split
DRIFT_NS = 50_000


def _low(values: list[int]) -> int:
    return sorted(values)[int(OFFSET_QUANTILE * len(values))]


def _between(xs: list[int], ys: list[int], t: int) -> int:
    """ys at t, linear between the points (xs, ys), flat beyond them."""
    k = bisect.bisect_left(xs, t)
    if k == 0 or k == len(xs) or xs[k] == xs[k - 1]:
        return ys[min(k, len(xs) - 1)]
    return ys[k - 1] + (ys[k] - ys[k - 1]) * (t - xs[k - 1]) // (xs[k] - xs[k - 1])


def device_intervals(prof) -> tuple[list[tuple[int, int]], dict | None]:
    """The device events of a torch.profiler trace as (start, end) ns on
    the host's clock, and the leads (device start - its launch call,
    matched as profiling.lost_device_events matches them) they were
    corrected by: `windows_ns`, the OFFSET_QUANTILE quantile of each
    window's leads, which the device events launched about then are moved
    back by (an event with no launch call of its own by its start);
    `step_ns`, the largest difference of neighbouring windows; `offset_ns`,
    the quantile over all leads; the least lead and the device event that
    has it, the median, how many leads are negative, and how many. None,
    and no correction, where the trace holds no launch call. Parse the
    trace (`events()`) before this, if at all: torch 2.13 crashed parsing
    a CPU trace whose kineto events had been read."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == cpu and e.name() in _LAUNCH_CALLS}
    dev = [e for e in events if e.device_type() == cuda and not e.name().startswith("ProfilerStep")]
    leads = sorted((launches[e.correlation_id()], e.start_ns() - launches[e.correlation_id()],
                    e.name()) for e in dev if e.correlation_id() in launches)
    if not leads:
        return [(e.start_ns(), e.end_ns()) for e in dev], None
    n = len(leads)
    w = max(1, min(OFFSET_WINDOWS, n // WINDOW_LEADS))
    parts = [leads[k * n // w:(k + 1) * n // w] for k in range(w)]
    xs = [p[len(p) // 2][0] for p in parts]
    ys = [_low([lead for _, lead, _ in p]) for p in parts]
    ns = sorted(lead for _, lead, _ in leads)
    least = min(leads, key=lambda x: x[1])
    info = {"windows_ns": ys, "step_ns": max((abs(b - a) for a, b in zip(ys, ys[1:])), default=0),
            "offset_ns": _low(ns), "least_ns": least[1], "least_event": least[2],
            "median_ns": ns[n // 2], "negative": sum(1 for v in ns if v < 0), "leads": n}
    out = []
    for e in dev:
        off = _between(xs, ys, launches.get(e.correlation_id(), e.start_ns()))
        out.append((e.start_ns() - off, e.end_ns() - off))
    return out, info


def _union(intervals) -> list[list[int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _covered(intervals, lo: int, hi: int) -> int:
    """Length of [lo, hi] that the intervals cover."""
    return sum(min(e, hi) - max(s, lo) for s, e in _union(intervals) if min(e, hi) > max(s, lo))


def innermost(spans: list, thread: int, start: int, end: int) -> list[tuple[int, int, int]]:
    """[start, end] cut into (from, to, span index) pieces by the innermost
    span of `thread` open over each (-1: none open)."""
    marks = []
    for i, (_, s, e, th, _, _) in enumerate(spans):
        if th == thread:
            marks += [(s, 1, i), (e, 0, -i)]
    marks.sort()  # at one instant closes first, a child's before its parent's
    pieces, open_, t = [], [], start
    for at, kind, key in marks:
        at = min(max(at, start), end)
        if at > t:
            pieces.append((t, at, open_[-1] if open_ else -1))
            t = at
        if kind:
            open_.append(key)
        else:
            open_.remove(-key)
    if end > t:
        pieces.append((t, end, open_[-1] if open_ else -1))
    return pieces


def _gaps(busy: list[list[int]], start: int, end: int) -> list[tuple[int, int]]:
    out, t = [], start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if end > t:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def reduce(record: dict, unit: str, device: list[tuple[int, int]] | None = None,
           leads: dict | None = None) -> dict | None:
    """The stretch's numbers: its wall seconds, units and spans, host ms a unit
    by span name (`host_ms`, `self_ms`), and with the device's events and
    their leads (device_intervals) the device's busy and idle ms a unit
    (`busy_ms`, `idle_total_ms`, `idle_ms`, `idle_self_ms`) and the leads.
    The idle is not split (no `idle_ms`, and `refused` says why) where
    neighbouring windows' offsets differ by more than DRIFT_NS. None where
    the record holds no unit."""
    spans = record["spans"]
    units = sum(1 for s in spans if s[0] == unit)
    if not units:
        return None
    children = defaultdict(list)
    for i, s in enumerate(spans):
        if s[4] >= 0:
            children[s[4]].append(i)

    def names_around(i: int) -> list[str]:
        out = []
        while i >= 0:
            out.append(spans[i][0])
            i = spans[i][4]
        return out

    host, own = defaultdict(int), defaultdict(int)
    for i, (name, s, e, _, parent, _) in enumerate(spans):
        own[name] += (e - s) - _covered([spans[c][1:3] for c in children[i]], s, e)
        if parent < 0 or name not in names_around(parent):
            host[name] += e - s
    per = 1e-6 / units
    out = {"units": units, "spans": len(spans), "wall_s": (record["end"] - record["start"]) / 1e9,
           "host_ms": {k: v * per for k, v in host.items()},
           "self_ms": {k: v * per for k, v in own.items()}}
    if device is None:
        return out
    start, end = record["start"], record["end"]
    idle = _gaps(_union(device), start, end)
    idle_ns = sum(e - s for s, e in idle)
    out.update(busy_ms=(end - start - idle_ns) * per, idle_total_ms=idle_ns * per, leads=leads)
    if leads and leads["step_ns"] > DRIFT_NS:
        out["refused"] = f"neighbouring offsets differ by more than {DRIFT_NS} ns"
        return out
    by_span = defaultdict(int)
    j = 0
    for a, b, i in innermost(spans, record["thread"], start, end):
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            by_span[i] += min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
    inner, around = defaultdict(int), defaultdict(int)
    for i, ns in by_span.items():
        names = names_around(i) if i >= 0 else [NONE]
        inner[names[0]] += ns
        for name in set(names):
            around[name] += ns
    out.update(idle_ms={k: v * per for k, v in around.items()},
               idle_self_ms={k: v * per for k, v in inner.items()})
    return out


class _Seen:
    """A trace's host event as stage_device_us reads it, with its name,
    parent and kernels replaced."""

    def __init__(self, event, name, kernels):
        self._event, self.name, self.kernels, self.cpu_parent = event, name, kernels, None

    def __getattr__(self, key):
        return getattr(self._event, key)


def stage_attribution(cpu_events, drop=(), kernels=None, own_thread_backward=False) -> dict:
    """port_bench/trace.py::stage_device_us over a trace's host events as
    they would read without the ranges "lfs.<name>" of `drop` (each such
    event keeps its kernels, named so that no stage is found in it).
    `kernels(event)` stands in for the events' kernels; with
    `own_thread_backward` an autograd node's events have no parent outside
    the node, as where autograd runs the backward on a thread of its own
    (the card's)."""
    dropped = {STAGE_PREFIX + n for n in drop}
    seen = {id(e): _Seen(e, "dropped " + e.name if e.name in dropped else e.name,
                         kernels(e) if kernels else e.kernels) for e in cpu_events}
    for e in cpu_events:
        parent = None if own_thread_backward and e.name.startswith(_BACKWARD) else e.cpu_parent
        while parent is not None and parent.name in dropped:
            parent = parent.cpu_parent
        if parent is not None and id(parent) not in seen:
            seen[id(parent)] = _Seen(parent, parent.name, [])
        seen[id(e)].cpu_parent = None if parent is None else seen[id(parent)]
    return stage_device_us([seen[id(e)] for e in cpu_events])


def moved_stages(cpu_events, kernels=None, own_thread_backward=False) -> dict:
    """What the host spans' ranges do to the stage attribution of a trace:
    {"changed": {stage: [without, with]} for every stage other than
    "other" whose time differs (none where only "other" gives time up),
    "without": the stage times as they read without the ranges, "with":
    as they read}."""
    without = stage_attribution(cpu_events, HOST_SPANS, kernels, own_thread_backward)
    with_ = stage_attribution(cpu_events, (), kernels, own_thread_backward)
    changed = {k: [v, with_.get(k, 0.0)] for k, v in without.items()
               if k != "other" and with_.get(k, 0.0) != v}
    return {"changed": changed, "without": without, "with": with_}


def host_ms(rec: dict, *names: str, self_time: bool = False):
    """Host ms a unit of the spans `names` (summed; their self time with
    `self_time`) in the spans stretch; None where it or a name is missing."""
    red = (rec.get("spans") or {}).get("host")
    table = red and red["self_ms" if self_time else "host_ms"]
    if not table or any(n not in table for n in names):
        return None
    return sum(table[n] for n in names)


def wall_ms(rec: dict):
    """Wall ms a unit of the spans stretch; None where it is missing."""
    red = (rec.get("spans") or {}).get("host")
    return 1e3 * red["wall_s"] / red["units"] if red else None


def idle_ms(rec: dict, name: str | None, less: tuple[str, ...] = ()):
    """Device idle ms a unit while span `name` is open on the recording
    thread (all of it for None), less the idle while spans `less` are: the
    attribution stretch's share of its idle in those spans, times the
    spans stretch's wall a unit less the attribution stretch's device busy
    a unit. None where a stretch, its split or `name` is missing."""
    wall, red = wall_ms(rec), (rec.get("spans") or {}).get("idle")
    if wall is None or not red or "idle_ms" not in red or not red["idle_total_ms"]:
        return None
    if name is None:
        part = red["idle_total_ms"]
    elif name in red["idle_ms"]:
        part = red["idle_ms"][name] - sum(red["idle_ms"].get(n, 0.0) for n in less)
    else:
        return None
    return part / red["idle_total_ms"] * (wall - red["busy_ms"])
