"""Frame graph (pipeline/framegraph.py primary_pass): ms a frame of the
port's `rt64.pass.primary` stage, the camera rays' closest hits (K1) and
their shading, alpha slots included. The stage is timed by the port
(utils/profiling.py) while the traced run's profiler records: CUDA events
at the pass's boundaries on the frame's stream, so its device time where
the device paces the frame and the time it holds the stream where the
host does. Its total over the profiled Device.draw calls over their
count; None where the program keeps no such record, where its frames
are not the profiled frames, or where the stage never ran."""

UNIT = "ms"
STAGE = "rt64.pass.primary"


def read(td):
    try:
        from rt64tpu_torch.utils.profiling import frame_stats
    except ImportError:  # a program without the stage record
        return None
    stats = frame_stats()
    frames = stats["frames"]
    if not frames or frames != len(td.frames) or STAGE not in stats["stage_ms"]:
        return None
    return stats["stage_ms"][STAGE] / frames
