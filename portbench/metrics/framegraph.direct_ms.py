"""Frame graph (pipeline/framegraph.py, ctx_from_rows through
direct_pass): ms a frame of the port's `rt64.pass.direct` stage, the
light picks, the shadow rays of every direct-light sample and the
transparent light (K2) and the direct light's accumulation. Timed and
reduced as framegraph.primary_ms (utils/profiling.py stage timers:
total over the profiled Device.draw calls over their count; None
without the record, with other frames than the profiled ones, or where
the stage never ran)."""

UNIT = "ms"
STAGE = "rt64.pass.direct"


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
