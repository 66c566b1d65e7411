"""P3's share of its roofline: the least time of the blend backward's work
(port_bench/work/counts.py) over P3's device time, per iteration."""

from port_bench.readers import roofline_percent


def read(rec):
    return roofline_percent(rec, "p3", "P3")
