"""Device ms of the world-space blend per iteration: the per-pixel ray
table, the stream of 3D gaussians, P5, P6 and P4, forward and backward."""

from port_bench.readers import stage_ms_per


def read(rec):
    return stage_ms_per(rec, "rays", "stream", "P5", "P6", "P4")
