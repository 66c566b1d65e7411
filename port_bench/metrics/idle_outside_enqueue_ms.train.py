"""Device idle ms an iteration outside what idle_enqueue_ms.train counts:
the feed, the read, or no span open (the loop's bookkeeping and the
control poll). The attribution stretch's share of its idle there, times
the untraced idle an iteration (spans.idle_ms)."""

from port_bench.spans import idle_ms


def read(rec):
    inside = idle_ms(rec, "dispatch", less=("loader_wait", "h2d"))
    return None if inside is None else idle_ms(rec, None) - inside
