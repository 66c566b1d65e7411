"""Host ms an iteration the trainer spends getting its view: the loader's
wait and the copy to the device, the pinned ring's event wait included
(spans `loader_wait` and `h2d` of the spans stretch)."""

from port_bench.spans import host_ms


def read(rec):
    return host_ms(rec, "loader_wait", "h2d")
