"""Device ms of the loss (L1, SSIM, the regularisers), forward and backward, per iteration."""

from port_bench.readers import stage_ms_per


def read(rec):
    return stage_ms_per(rec, "loss")
