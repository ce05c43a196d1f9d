"""Object model and scene packing (pipeline/scene_buffers.ScenePacker,
convert.global_params_from_numpy): the bytes the port copies from the
host to the device a frame, as its upload counter (utils/profiling.py
upload) adds them while the traced run's profiler records: the packed
rows (the whole geometry epoch where a mesh was re-set), the frame's
scalars and the global parameters. The total over the profiled
Device.draw calls over their count; None where the program keeps no
such record or where its frames are not the profiled frames."""

UNIT = "bytes/frame"


def read(td):
    try:
        from rt64tpu_torch.utils.profiling import frame_stats
    except ImportError:  # a program without the upload counter
        return None
    stats = frame_stats()
    frames = stats["frames"]
    if not frames or frames != len(td.frames):
        return None
    return stats["upload_bytes"] / frames
