"""The reduction from a torch.profiler trace to the benchmark's numbers:
device busy time and the traced window, device time by stage, the top
device operations and the longest idle gaps by what the host was doing.

The stage ranges are the program's: `lfs.<stage>` record-function ranges
around the render's and the train step's stages. A device event counts
toward the innermost range around the host op that launched it, and work
of the backward, which runs in autograd nodes outside every range, toward
"<stage> bwd", the stage whose forward op made the node (a copy of the
arithmetic in the program's profiling.py, kept here so that the
yardstick does not move with the program).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

STAGE_PREFIX = "lfs."
_BACKWARD = "autograd::engine::evaluate_function"
LEAD_IN = 32  # small launches that turn device tracing on before the body
SETTLE_S = 0.1


@contextlib.contextmanager
def device_trace(host: bool = True):
    """A CUDA profile of the body, with the host's ops where `host` is set.
    Recording every host op slows the host several times over, so the busy
    time and the window come from a profile without them, and the stage
    times from one with them. Device tracing is turned on a profiler
    cycle early, on LEAD_IN small launches it does not keep, and the body
    starts SETTLE_S into the kept cycle: a profiler started right before
    the work loses the device events of the first launches, and the device
    clock may read behind the host's."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(
            wait=0, warmup=1, active=1)) as prof:
        x = torch.zeros(64, device="cuda")
        for _ in range(LEAD_IN):
            x.add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(SETTLE_S)
        yield prof
        torch.cuda.synchronize()


def device_events(prof) -> list:
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]


def _union(intervals):
    """(busy length, merged intervals) of [start, end] intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def _stage_name(chain):
    return next((a.name[len(STAGE_PREFIX):] for a in chain if a.name.startswith(STAGE_PREFIX)),
                None)


def stage_device_us(cpu_events) -> dict[str, float]:
    """Device microseconds by stage over host events (see the module
    docstring)."""
    seq_stage = {}
    for e in sorted(cpu_events, key=lambda e: e.time_range.start):
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
    for e in cpu_events:
        t = sum(k.duration for k in e.kernels)
        if not t:
            continue
        chain = list(_ancestors(e))
        name = _stage_name(chain)
        if name is None:
            node = next((a for a in chain if a.name.startswith(_BACKWARD)), None)
            fwd = seq_stage.get((node.fwd_thread, node.sequence_nr)) if node is not None else None
            name = f"{fwd} bwd" if fwd else "other"
        out[name] += t
    return dict(out)


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without its return type, argument list and the
    namespaces of PyTorch's templates, cut to `limit` characters."""
    name = name.removeprefix("void ")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the argument list: the last top-level "(...)"
        if ch in "<(":
            depth += 1
            if ch == "(" and depth == 1:
                cut = i
        elif ch in ">)":
            depth -= 1
    name = name[:cut] if cut else name
    for ns in ("at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(ns, "")
    return name[:limit].strip()


def busy(prof, window_s: float, top: int = 10) -> dict:
    """From a profile of the device alone: busy_s, window_s, the device's
    events and its top operations by time."""
    dev = device_events(prof)
    busy_us, _ = _union([(e.time_range.start, e.time_range.end) for e in dev])
    by_name: dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[short_name(e.name)] += e.time_range.end - e.time_range.start
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us / 1e6, "window_s": window_s, "events": len(dev),
            "device_ops": [[n, us / 1e6] for n, us in ops]}


def stages(prof, top: int = 10) -> dict:
    """From a profile with the host's ops: the stage device ms, the
    host-to-device copies (count and device ms) and the longest idle gaps,
    each named by the innermost host op over its middle."""
    dev = device_events(prof)
    cpu = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    _, merged = _union([(e.time_range.start, e.time_range.end) for e in dev])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    named = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        over = [c for c in cpu if c.time_range.start <= mid <= c.time_range.end]
        inner = min(over, key=lambda c: c.time_range.end - c.time_range.start, default=None)
        named.append([inner.name if inner is not None else "no host op", length / 1e6])
    h2d = [e for e in dev if "htod" in e.name.lower()]
    return {
        "stage_ms": {k: v / 1e3 for k, v in stage_device_us(cpu).items()},
        "h2d_ms": sum(e.time_range.end - e.time_range.start for e in h2d) / 1e3,
        "h2d_copies": len(h2d),
        "idle_gaps": named,
    }


def summarize(busy_prof, busy_window_s: float, busy_units: int, stage_prof,
              stage_units: int, plain_s: float, plain_units: int) -> dict:
    """The traced run's readings: the device-only profile's busy time over
    its window and units (iterations or frames), the host-op profile's
    stage times per its units, the breakdown (the device-only profile's
    top operations, the host-op profile's longest gaps), and the seconds
    and units of the untraced stretch timed by the host's clock before
    them (the profiler slows the host, so a traced window's wall time is
    not the program's)."""
    b, s = busy(busy_prof, busy_window_s), stages(stage_prof)
    return {
        "busy_s": b["busy_s"], "window_s": b["window_s"], "events": b["events"],
        "units": busy_units, "stage_units": stage_units,
        "plain_s": plain_s, "plain_units": plain_units,
        "stage_ms": s["stage_ms"], "h2d_ms": s["h2d_ms"], "h2d_copies": s["h2d_copies"],
        "breakdown": {"device_ops": b["device_ops"], "idle_gaps": s["idle_gaps"]},
    }
