"""Frame graph (pipeline/framegraph.py, ops/*, the models/ upscale slot):
device time a frame, the sum of every device operation's duration in the
profiled frames over their count (the port's frame_profile arithmetic)."""

UNIT = "ms"


def read(td):
    if not td.frames or not td.kernels:
        return None
    return sum(b - a for _, a, b in td.kernels) / 1e3 / len(td.frames)
