"""Device ms of Adam and the MCMC strategy (noise, refines) per iteration."""

from port_bench.readers import stage_ms_per


def read(rec):
    return stage_ms_per(rec, "Adam", "MCMC")
