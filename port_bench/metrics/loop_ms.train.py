"""Host ms an iteration in the trainer's loop outside its dispatch and its
read (spans stretch: the wall a unit less spans `dispatch` and
`readback`): the loop's bookkeeping and the live control's poll."""

from port_bench.spans import host_ms, wall_ms


def read(rec):
    wall, inside = wall_ms(rec), host_ms(rec, "dispatch", "readback")
    return None if wall is None or inside is None else wall - inside
