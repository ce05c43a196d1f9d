"""Frame graph (pipeline/framegraph.py reflection_bounces): the share (%)
of the reflection bounces' lanes that carry a live mirror ray, as the
port's frame record counts them (utils/profiling.py frame_stats:
reflection_live_rays, the live mirror rays of the bounces each render
issued), over render pixels x max_reflections x the profiled renders.
What the traffic asks of the bounces: every program that renders the
frame right reads the same, and one that loses mirror rays reads less.
The work the bounces do is framegraph.reflection_traced_share. None
where the program keeps no such count, where its frames are not the
profiled frames, or where the cell traces no reflection."""

UNIT = "%"
COUNT = "reflection_live_rays"


def read(td):
    try:
        from rt64tpu_torch.utils.profiling import frame_stats
    except ImportError:  # a program without the frame record
        return None
    stats = frame_stats()
    frames, renders = stats["frames"], stats["renders"]
    width, height = td.cfg["render"]
    lanes = width * height * td.cfg.get("max_reflections", 0) * renders
    if (not frames or frames != len(td.frames) or COUNT not in stats
            or not lanes):
        return None
    return 100.0 * stats[COUNT] / lanes
