"""Share of an untraced iteration's wall time in which nothing ran on the
device: busy per iteration from the device-only profile, wall time per
iteration from the untraced stretch timed just before it."""

from port_bench.readers import idle_percent


def read(rec):
    return idle_percent(rec)
