"""Helpers of the per-layer readers in metrics/: each reader takes the
run's readings ("trace": port_bench/trace.py::summarize of the traced run,
"work": port_bench/work/counts.py's counts) and returns its metric, or None
where the run holds nothing for it to read."""

from __future__ import annotations

from port_bench.work.counts import least_seconds


def busy_trace(rec: dict):
    """The device-only profile's summary, or None."""
    tr = rec.get("trace")
    return tr if tr and tr.get("units") else None


def stage_ms_per(rec: dict, *stages: str):
    """Device ms per iteration (or frame) of the stages, their backward
    nodes included; None where no stage ran on the device."""
    tr = rec.get("trace")
    if not tr or not tr.get("stage_units"):
        return None
    found = [tr["stage_ms"][s] for name in stages for s in (name, f"{name} bwd")
             if s in tr["stage_ms"]]
    return sum(found) / tr["stage_units"] if found else None


def untraced_s_per(rec: dict):
    """Wall seconds per iteration (or frame) of the untraced stretch that
    the traced run times just before its profiles; None without it."""
    tr = busy_trace(rec)
    return tr["plain_s"] / tr["plain_units"] if tr and tr.get("plain_units") else None


def idle_percent(rec: dict):
    """The share of an untraced unit's wall time in which nothing runs on
    the device: 1 - device busy per unit (the device-only profile) over
    wall seconds per unit (the untraced stretch)."""
    wall = untraced_s_per(rec)
    if wall is None:
        return None
    tr = rec["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["units"] / wall)


def roofline_percent(rec: dict, work: str, *stages: str):
    """The least time of `work` (its "<work>_flops" and "<work>_bytes") over
    the stages' device time, in percent."""
    ms = stage_ms_per(rec, *stages)
    w = rec.get("work") or {}
    if ms is None or f"{work}_flops" not in w:
        return None
    return 100.0 * least_seconds(w[f"{work}_flops"], w[f"{work}_bytes"]) / (ms / 1e3)
