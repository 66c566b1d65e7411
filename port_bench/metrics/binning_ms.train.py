"""Device ms of the binning stage (P1, the sort, the tile ranges) per iteration."""

from port_bench.readers import stage_ms_per


def read(rec):
    return stage_ms_per(rec, "binning")
