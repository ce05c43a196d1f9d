"""Frame graph, light selection (ops/lighting.plan_lights): ms a frame of
the port's `rt64.lights.plan` stage, every light plan of the frame
(the direct light's selection rounds over every light of the scene,
and the one-light plans of the transparent light, the GI bounce, the
refraction and each reflection bounce): each light tested against the
point's light group mask, the first 16 candidates, the picks and their
disk samples. Timed and reduced as framegraph.primary_ms
(utils/profiling.py stage timers: total over the profiled Device.draw
calls over their count; None without the record, with other frames
than the profiled ones, or where the stage never ran)."""

UNIT = "ms"
STAGE = "rt64.lights.plan"


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
