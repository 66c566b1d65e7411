"""Device busy ms per frame in the device-only traced window."""

from port_bench.readers import busy_trace


def read(rec):
    tr = busy_trace(rec)
    return None if tr is None else 1e3 * tr["busy_s"] / tr["units"]
