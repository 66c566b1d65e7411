"""Device events (kernels, copies, fills) per frame in the device-only traced window."""

from port_bench.readers import busy_trace


def read(rec):
    tr = busy_trace(rec)
    return None if tr is None else tr["events"] / tr["units"]
