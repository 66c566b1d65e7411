"""P2's share of its roofline on a frame: the least time of the forward
blend's work (port_bench/work/counts.py) over P2's device time."""

from port_bench.readers import roofline_percent


def read(rec):
    return roofline_percent(rec, "p2", "P2")
