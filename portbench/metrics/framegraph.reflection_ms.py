"""Frame graph (pipeline/framegraph.py reflection_pass): ms a frame of the
port's `rt64.pass.reflection` stages, every reflection bounce of the frame
summed (one stage a bounce under the one name). Timed and reduced as
framegraph.primary_ms (utils/profiling.py stage timers: total over the
profiled Device.draw calls over their count; None without the record,
with other frames than the profiled ones, or where the stage never
ran)."""

UNIT = "ms"
STAGE = "rt64.pass.reflection"


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
