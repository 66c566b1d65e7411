"""Structured logging.

Reference: include/core/logger.hpp (spdlog wrapper with per-module levels,
console+file sinks). Python logging with the same surface. Timing of host
phases is profiling.stage's: profiler ranges, and host spans inside
profiling.record_spans().
"""

from __future__ import annotations

import logging
import sys
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
