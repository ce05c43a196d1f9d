"""Frame graph (pipeline/framegraph.py reflection_bounces): the share (%)
of the full-width reflection bounces' lanes that the bounces traced, as
the port's frame record counts them (utils/profiling.py frame_stats:
reflection_traced_lanes, the lanes of the live mirror rays' cull
bundles in each bounce a render issued), over render pixels x
max_reflections x the profiled renders: the work the bounces still do,
at least framegraph.reflection_live_share. None where the program keeps
no such count, where its frames are not the profiled frames, or where
the cell traces no reflection."""

UNIT = "%"
COUNT = "reflection_traced_lanes"


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
