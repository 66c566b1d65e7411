"""Structured logging + scoped timers.

Reference: include/core/logger.hpp (spdlog wrapper with per-module levels,
console+file sinks, ScopedTimer RAII profiling :194-212). Python logging
with the same surface; `trace_annotation` additionally emits a
torch.profiler range (profiling.stage), so device timelines carry
host-side phase names.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_root = logging.getLogger("lfs_torch")


def setup_logging(level: str = "info", log_file: Optional[str] = None,
                  module_levels: Optional[dict[str, str]] = None) -> None:
    """--log-level/--log-file semantics (argument_parser.cpp:140-141,183-204)
    plus per-module filters (logger.hpp:28-42)."""
    lvl = {"trace": TRACE, "debug": logging.DEBUG, "info": logging.INFO,
           "warn": logging.WARNING, "error": logging.ERROR}[level.lower()]
    _root.setLevel(lvl)
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s", "%H:%M:%S")
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(fmt)
    _root.handlers = [h]
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        _root.addHandler(fh)
    for mod, ml in (module_levels or {}).items():
        logging.getLogger(f"lfs_torch.{mod}").setLevel(
            {"trace": TRACE, "debug": logging.DEBUG, "info": logging.INFO,
             "warn": logging.WARNING, "error": logging.ERROR}[ml.lower()]
        )


def get_logger(module: str = "") -> logging.Logger:
    return logging.getLogger(f"lfs_torch.{module}" if module else "lfs_torch")


class ScopedTimer:
    """RAII wall-clock timer (reference logger.hpp:194-212 LOG_TIMER)."""

    def __init__(self, name: str, logger: Optional[logging.Logger] = None,
                 level: int = logging.DEBUG):
        self.name = name
        self.logger = logger or _root
        self.level = level
        self.elapsed_ms: float = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_ms = (time.perf_counter() - self.t0) * 1000.0
        self.logger.log(self.level, "%s: %.2f ms", self.name, self.elapsed_ms)
        return False


def trace_annotation(name: str):
    """Host + device profiler annotation: the range "lfs.<name>" of
    profiling.stage, which a torch.profiler trace links its kernels to."""
    from lichtfeld_studio_tpu_torch.profiling import stage

    return stage(name)
