"""Stage ranges of the render and the train step, and what a torch.profiler
trace of them says: device events, busy share, device time per stage.

`rasterize`, `compute_grads`, `apply_update` and the blend's backward run
each stage inside `stage(name)`, a profiler range "lfs.<name>". A trace
links each device kernel, copy and fill to the host op that launched it;
`stage_device_ms` counts it toward the innermost range around that op, and
the backward's kernels, which run in autograd nodes outside every range,
toward "<stage> bwd", the stage whose forward op made the node.

Trace with `device_trace()`: a profiler started right before the work
can lose the device events of the first launches after it starts
(`lost_device_events` counts them), and with them the first stage's time.
"""

from __future__ import annotations

import contextlib
import time
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
