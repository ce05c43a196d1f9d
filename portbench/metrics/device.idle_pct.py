"""Device (one H100): the share (%) of the profiled window in which no
device operation ran: 100 x (1 - the union of their intervals / the
window, from the first profiled frame's start to the last one's end)."""

UNIT = "%"


def read(td):
    from portbench.trace import busy_us

    if not td.kernels or td.window_us <= 0:
        return None
    return 100.0 * (1.0 - busy_us(td.kernels) / td.window_us)
