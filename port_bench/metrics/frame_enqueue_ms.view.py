"""Host ms a frame inside `render_frame_u8` (span `frame`, spans
stretch): the frame's enqueue, rasterize and quantise."""

from port_bench.spans import host_ms


def read(rec):
    return host_ms(rec, "frame")
