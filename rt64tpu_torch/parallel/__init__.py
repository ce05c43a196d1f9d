"""Row tiling: a frame drawn as horizontal bands (tiling.py)."""
