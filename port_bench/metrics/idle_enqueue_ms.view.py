"""Device idle ms a frame while the viewer's thread is inside
`render_frame_u8` (span `frame`): the attribution stretch's share of its
idle there, times the untraced idle a frame (spans.idle_ms)."""

from port_bench.spans import idle_ms


def read(rec):
    return idle_ms(rec, "frame")
