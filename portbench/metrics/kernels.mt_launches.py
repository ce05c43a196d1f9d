"""Kernels: launches a frame of K3 and K4 (csrc/mt_tracer.cu, the
Moller-Trumbore walks that scenes past the size switch take), as the
port's frame record counts them (utils/profiling.py frame_stats:
opaque_mt_launches and shadow_mt_launches, added where
tracer_cuda.launch_counts counts each launch) over the profiled
Device.draw calls, over their count. None where the program keeps no
such counts or where its frames are not the profiled frames."""

UNIT = "launches/frame"
COUNTS = ("opaque_mt_launches", "shadow_mt_launches")


def read(td):
    try:
        from rt64tpu_torch.utils.profiling import frame_stats
    except ImportError:  # a program without the frame record
        return None
    stats = frame_stats()
    frames = stats["frames"]
    if not frames or frames != len(td.frames) or not all(
            k in stats for k in COUNTS):
        return None
    return sum(stats[k] for k in COUNTS) / frames
