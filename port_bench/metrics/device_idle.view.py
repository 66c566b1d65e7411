"""Share of an untraced frame's wall time in which nothing ran on the
device: busy per frame from the device-only profile, wall time per frame
from the untraced stretch timed just before it."""

from port_bench.readers import idle_percent


def read(rec):
    return idle_percent(rec)
