"""The whole train step's share of the card's peak: the least time its counted
work needs (port_bench/work/counts.py) over the wall time of an iteration
in the untraced stretch that the traced run times before its profiles."""

from port_bench.readers import untraced_s_per
from port_bench.work.counts import least_seconds


def read(rec):
    wall = untraced_s_per(rec)
    w = rec.get("work") or {}
    if wall is None or "step_flops" not in w:
        return None
    return 100.0 * least_seconds(w["step_flops"], w["step_bytes"]) / wall
