"""What the harness and its drivers share: a cell's context, a driver's
result and one number of the correctness check."""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "port_bench"  # fixed: datasets, Triton's cache, run outputs
HERE = Path(__file__).resolve().parent  # configs/, traffic/, drivers/, metrics/, limits/


@dataclass
class Check:
    """One number of the correctness comparison and its limit (a number
    passes at or below its limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Result:
    metrics: dict  # end-to-end metric name -> value
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: list
    readings: dict = field(default_factory=dict)  # what the per-layer readers read
    trace: dict | None = None  # trace.summarize() of the traced window


@dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    cache: Path = CACHE
    base: Path = HERE  # where the cell's traffic, limits, driver and readers are
    window_start: float | None = None
    log: object = field(default=lambda msg: print(msg, file=sys.stderr, flush=True))

    created: float = field(default_factory=time.perf_counter)

    def start_window(self) -> None:
        self.window_start = time.perf_counter()
        self.mark("window opens")

    def mark(self, what: str) -> None:
        """Log a phase of the run with the seconds since the context was made."""
        self.log(f"[port_bench] {what} at {time.perf_counter() - self.created:.3f} s")



def pin_host_threads():
    """Give the calling thread a core of its own and every other thread of
    the process the other cores, so that a thread it wakes (the loader's)
    is never queued on the core that enqueues the device's work. Returns
    (what was done, the function that gives every thread its cores back)."""
    cores = sorted(os.sched_getaffinity(0))
    tids = [int(t) for t in os.listdir("/proc/self/task")]
    if len(cores) < 2:
        return "one core: threads left as they were", lambda: None
    me = threading.get_native_id()
    for tid in tids:
        try:
            os.sched_setaffinity(tid, {cores[-1]} if tid == me else cores[:-1])
        except OSError:  # a thread that has ended
            pass

    def restore():
        for tid in os.listdir("/proc/self/task"):
            try:
                os.sched_setaffinity(int(tid), cores)
            except OSError:
                pass

    return (f"thread {me} on core {cores[-1]}, {len(tids) - 1} other threads on cores "
            f"{cores[0]}-{cores[-2]}"), restore


def sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def memory_peak(device) -> int:
    """The process's peak of allocated device memory (0 off the card)."""
    import torch

    return torch.cuda.max_memory_allocated() if str(device).startswith("cuda") else 0
