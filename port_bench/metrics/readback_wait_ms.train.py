"""Host ms an iteration in the dispatch's one device-to-host read (span
`readback`, spans stretch), the wait for the device included."""

from port_bench.spans import host_ms


def read(rec):
    return host_ms(rec, "readback")
