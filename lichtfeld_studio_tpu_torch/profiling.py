"""Stage ranges of the render and the train step, and what a torch.profiler
trace of them says: device events, busy share, device time per stage.

`rasterize`, `compute_grads`, `apply_update` and the blend's backward run
each stage inside `stage(name)`, a profiler range "lfs.<name>". A trace
links each device kernel, copy and fill to the host op that launched it;
`stage_device_ms` counts it toward the innermost range around that op, and
the backward's kernels, which run in autograd nodes outside every range,
toward "<stage> bwd", the stage whose forward op made the node.
"""

from __future__ import annotations

from collections import defaultdict

import torch

STAGE_PREFIX = "lfs."
_BACKWARD = "autograd::engine::evaluate_function"


def stage(name: str):
    """Profiler range "lfs.<name>" around a stage. It is recorded as a
    function, not as a user annotation, so that a kernel launched inside it
    with no aten op around the launch (the ctypes kernels of kernels/) is
    linked to the range in a trace: a user annotation takes no kernels."""
    return torch._C._profiler._RecordFunctionFast(STAGE_PREFIX + name)


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
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
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
    range around the event (the event itself included); else, for work of
    the backward, "<stage> bwd"; else "other". An autograd node carries
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
        chain = list(_ancestors(e))
        name = _stage_name(chain)
        if name is None:
            node = next((a for a in chain if a.name.startswith(_BACKWARD)), None)
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
