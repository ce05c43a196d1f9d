"""View driver (pipeline/view.py): the synchronising CUDA calls a frame
makes, as torch's sync-debug mode reports them over whole frames (the
sites by file:line are printed on standard error)."""

UNIT = "syncs/frame"


def read(td):
    if not td.sync_frames:
        return None
    return sum(td.sync_sites.values()) / td.sync_frames
