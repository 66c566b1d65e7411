"""Host ms an iteration inside the trainer's dispatch, outside the feed
(`dispatch` less `loader_wait` and `h2d`, spans stretch): the enqueue of
the step's device work."""

from port_bench.spans import host_ms


def read(rec):
    total, feed = host_ms(rec, "dispatch"), host_ms(rec, "loader_wait", "h2d")
    return None if total is None or feed is None else total - feed
