"""The port's golden frame (the frame of tests/test_golden.py: the sample
scene at 160x120 with a HUD triangle, two draws) on the CPU against the
checked-in tests/golden/sample_160x120.png at SSIM >= 0.98, the JAX
test's own bound (measured: 0.99999999). The PNG is read with the port's
own decoder, which must equal the JAX package's reader byte for byte, on
the golden file and on files whose rows use each of the five filters."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from rt64tpu.utils.assets import read_image as jax_read_image

from rt64tpu_torch.utils.assets import read_image
from rt64tpu_torch.utils.ssim import ssim
from rt64tpu_torch.utils.testscenes import build_sample_scene, hud_triangle

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sample_160x120.png")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny eager ops while other workers run: one intra-op thread
    is the fastest. The worker's setting comes back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_png_reader_matches():
    mine = read_image(GOLDEN)
    assert mine.dtype == np.uint8 and mine.shape == (120, 160, 4)
    np.testing.assert_array_equal(mine, jax_read_image(GOLDEN))


def _png(path, pixels):
    """Write pixels (H, W, C) as PNG with row y filtered by type y % 5."""
    h, w, c = pixels.shape
    bpp, stride = c, w * c
    rows = pixels.reshape(h, stride).astype(np.int64)
    raw = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        else:
            pred = [0 * cur, left, prev, (left + prev) >> 1][ftype]
        raw += bytes([ftype]) + bytes(((cur - pred) & 0xFF).astype(np.uint8))
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             {3: 2, 4: 6}[c], 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
def test_png_reader_every_row_filter(tmp_path, channels):
    rng = np.random.default_rng(channels)
    pixels = rng.integers(0, 256, (23, 17, channels), dtype=np.uint8)
    path = str(tmp_path / "filters.png")
    _png(path, pixels)
    mine = read_image(path)
    np.testing.assert_array_equal(mine, jax_read_image(path))
    np.testing.assert_array_equal(mine[..., :channels], pixels)


def test_golden_sample_frame():
    dev, scene, view = build_sample_scene(width=160, height=120, device="cpu")
    hud_triangle(scene, dev, color=(1.0, 0.15, 0.1, 0.85))
    dev.draw()
    dev.draw()
    frame = view.framebuffer()[..., :3]
    score = ssim(frame, read_image(GOLDEN)[..., :3])
    assert score >= 0.98, f"SSIM {score:.4f} < 0.98 vs golden"
