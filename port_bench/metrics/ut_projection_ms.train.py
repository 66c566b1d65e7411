"""Device ms of the UT projection with SH (3DGUT's seven sigma points a
gaussian), forward and backward, per iteration."""

from port_bench.readers import stage_ms_per


def read(rec):
    return stage_ms_per(rec, "ut_projection")
