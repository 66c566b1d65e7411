"""Device ms of the 2D blend per iteration: P2 (training), P3, P4."""

from port_bench.readers import stage_ms_per


def read(rec):
    return stage_ms_per(rec, "P2", "P3", "P4")
