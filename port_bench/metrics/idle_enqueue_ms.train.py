"""Device idle ms an iteration while the trainer's thread is inside a
dispatch, outside `loader_wait` and `h2d`: idle that the enqueue leaves.
The attribution stretch's share of its idle there, times the untraced
idle an iteration (spans.idle_ms)."""

from port_bench.spans import idle_ms


def read(rec):
    return idle_ms(rec, "dispatch", less=("loader_wait", "h2d"))
