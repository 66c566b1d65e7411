"""P6's share of its roofline: the least time of the world-space blend
backward's work (port_bench/work/counts.py) over P6's device time, per
iteration."""

from port_bench.readers import roofline_percent


def read(rec):
    return roofline_percent(rec, "p6", "P6")
