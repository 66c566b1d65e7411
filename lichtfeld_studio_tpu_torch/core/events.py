"""Typed publish/subscribe event bus.

Reference: include/core/event_bus.hpp:28-210 + events.hpp:20-189 (~60 event
structs in cmd/tools/state/ui/internal namespaces driving the GUI). The
headless framework keeps the same decoupling surface for progress/metrics
consumers (web UI, notebooks, loggers): typed dataclass events, `when`
subscriptions with handler ids, `off` to unsubscribe, emit counters for
debugging."""

from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Callable, Type, TypeVar

T = TypeVar("T")


class EventBus:
    def __init__(self):
        self._handlers: dict[type, dict[int, Callable]] = defaultdict(dict)
        self._next_id = 0
        self._lock = threading.Lock()
        self.emit_counts: dict[type, int] = defaultdict(int)

    def when(self, event_type: Type[T], handler: Callable[[T], None]) -> int:
        """Subscribe; returns a handler id (event_bus.hpp `when`)."""
        with self._lock:
            hid = self._next_id
            self._next_id += 1
            self._handlers[event_type][hid] = handler
            return hid

    def off(self, event_type: type, handler_id: int) -> bool:
        with self._lock:
            return self._handlers[event_type].pop(handler_id, None) is not None

    def emit(self, event: Any) -> int:
        """Dispatch to all handlers of the event's type; returns the number
        of handlers invoked."""
        with self._lock:
            handlers = list(self._handlers[type(event)].values())
            self.emit_counts[type(event)] += 1
        for h in handlers:
            h(event)
        return len(handlers)


_global_bus = EventBus()


def bus() -> EventBus:
    return _global_bus


# ---------------------------------------------------------------------------
# Event types (subset of reference events.hpp most relevant headless)
# ---------------------------------------------------------------------------
@dataclass
class TrainingProgress:
    iteration: int
    loss: float
    num_gaussians: int
    is_refining: bool = False


@dataclass
class EvaluationCompleted:
    iteration: int
    psnr: float
    ssim: float
    lpips: float


@dataclass
class CheckpointSaved:
    iteration: int
    path: str


@dataclass
class TrainingCompleted:
    iterations: int
    elapsed_s: float
    final_loss: float


@dataclass
class MemoryUsage:
    hbm_bytes_used: int
    hbm_bytes_total: int


@dataclass
class FrameRendered:
    render_ms: float
    fps: float


# --- command events (reference cmd:: namespace, events.hpp:20-60) --------
@dataclass
class PauseTraining:
    pass


@dataclass
class ResumeTraining:
    pass


@dataclass
class SaveCheckpoint:
    pass


@dataclass
class StopTraining:
    pass


@dataclass
class TrainingPaused:
    iteration: int


@dataclass
class TrainingResumed:
    iteration: int


@dataclass
class TrainingStopped:
    iteration: int
