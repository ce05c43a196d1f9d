"""Object model and scene packing (api.Scene.update -> pipeline/view
ViewRenderer.update -> pipeline/scene_buffers.ScenePacker): host ms of
Scene.update as Device.draw calls it, the mean over the frames of the
traced run's first part (no other instrument on)."""

UNIT = "ms"


def read(td):
    if not td.scene_update_ms:
        return None
    return sum(td.scene_update_ms) / len(td.scene_update_ms)
