"""Device ms of the EWA projection with SH, forward and backward, per iteration."""

from port_bench.readers import stage_ms_per


def read(rec):
    return stage_ms_per(rec, "projection")
