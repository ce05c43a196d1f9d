"""Frame graph: device kernels launched a frame in the profiled frames
(copies and fills left out)."""

UNIT = "launches/frame"


def read(td):
    if not td.frames:
        return None
    n = sum(1 for name, _, _ in td.kernels
            if not name.startswith(("Memcpy", "Memset")))
    return n / len(td.frames) if n else None
