"""Frame graph, light selection (ops/lighting.trace_plans): the shadow
lanes a frame's light plans hand to the shadow trace, as the port's
frame record counts them (utils/profiling.py frame_stats:
light_shadow_lanes, selection rounds x samples x points summed over
the plans each trace_plans call takes), over the profiled Device.draw
calls, over their count. The direct light's share is max_lights rounds
of the render's pixels; the transparent light, the GI bounce and the
refraction add one round of their lanes (the reflection bounces' light
casts no shadow ray). None where the program keeps no such count
or where its frames are not the profiled frames."""

UNIT = "lanes/frame"
COUNT = "light_shadow_lanes"


def read(td):
    try:
        from rt64tpu_torch.utils.profiling import frame_stats
    except ImportError:  # a program without the frame record
        return None
    stats = frame_stats()
    frames = stats["frames"]
    if not frames or frames != len(td.frames) or COUNT not in stats:
        return None
    return stats[COUNT] / frames
