"""DDS textures in the port against the JAX package, on the CPU.

- decode_dds equals the JAX package's byte for byte on BC1 (random end
  points, and every block opaque or every block punch-through), BC2 and
  BC3, at 4x4, 8x12 and 13x7 (not a multiple of the 4x4 block), on files
  of random blocks made from a seed with numpy (testscenes.dds_file);
  also through a DX10 header. Raw (uncompressed) RGBA8 decodes in the
  port; the JAX package reads its bit count 4 bytes late and refuses it.
- A BC1, a BC2 and a BC3 texture on the sample scene's sphere (64x48, no
  GI, no reflections) draw the JAX package's frame byte for byte.
"""

import struct

import numpy as np
import pytest
import torch

import rt64tpu
from rt64tpu.utils import assets as jassets
from rt64tpu.utils.testscenes import build_sample_scene as jax_sample

import rt64tpu_torch
from rt64tpu_torch import descriptors as d
from rt64tpu_torch.utils import assets as passets
from rt64tpu_torch.utils.testscenes import build_sample_scene as port_sample
from rt64tpu_torch.utils.testscenes import dds_file

SIZES = [(4, 4), (8, 12), (13, 7)]
FORMATS = [(b"DXT1", None), (b"DXT1", False), (b"DXT1", True), (b"DXT3", None),
           (b"DXT5", None)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("fourcc,punch", FORMATS,
                         ids=lambda v: v.decode() if isinstance(v, bytes)
                         else {None: "mixed", False: "opaque", True: "punch"}[v])
def test_decode_matches_jax(fourcc, punch, size):
    w, h = size
    data = dds_file(fourcc, w, h, seed=w * 100 + h, bc1_punch=punch)
    got = passets.decode_dds(data)
    assert got.shape == (h, w, 4) and got.dtype == np.uint8
    assert np.array_equal(got, jassets.decode_dds(data))
    if punch is not None:  # BC1: only the punch-through blocks are clear
        assert bool((got[..., 3] == 0).any()) == punch


def test_dx10_header_and_raw_rgba8():
    data = dds_file(b"DXT5", 8, 8, seed=1)
    dx10 = bytearray(data[:128]) + struct.pack("<5I", 77, 3, 0, 1, 0) + data[128:]
    dx10[84:88] = b"DX10"
    assert np.array_equal(passets.decode_dds(bytes(dx10)),
                          passets.decode_dds(data))
    assert np.array_equal(passets.decode_dds(bytes(dx10)),
                          jassets.decode_dds(bytes(dx10)))

    rgba = np.random.default_rng(2).integers(0, 256, (5, 6, 4), np.uint8)
    raw = bytearray(data[:128])
    struct.pack_into("<I", raw, 80, 0x41)  # DDPF_RGB | DDPF_ALPHAPIXELS
    struct.pack_into("<6I", raw, 84, 0, 32, 0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    struct.pack_into("<2I", raw, 12, 5, 6)
    raw = bytes(raw) + rgba.tobytes()
    got = passets.decode_dds(raw)
    assert np.array_equal(got, rgba[..., [2, 1, 0, 3]])
    # The JAX package reads the bit count and masks 4 bytes late: it takes
    # the red mask for the bit count and refuses the file.
    with pytest.raises(ValueError, match="uncompressed"):
        jassets.decode_dds(raw)
    with pytest.raises(ValueError, match="not a DDS"):
        passets.decode_dds(b"PNG " + raw[4:])


def _with_dds(make, pkg, fourcc, punch, **kw):
    dev, scene, view = make(64, 48, gi_samples=0, **kw)
    view.max_reflections = 0
    data = dds_file(fourcc, 32, 32, seed=11, bc1_punch=punch)
    tex = pkg.Texture(dev, pkg.TextureDesc(bytes=data, byte_count=len(data),
                                           format=d.TEXTURE_FORMAT_DDS))
    sphere = scene.instances[0]
    sphere.desc.diffuse_texture = tex
    sphere.set_description(sphere.desc)
    dev.draw()
    return tex, view.framebuffer().copy()


@pytest.mark.parametrize("fourcc,punch", [(b"DXT1", False), (b"DXT3", None),
                                          (b"DXT5", None)],
                         ids=["bc1", "bc2", "bc3"])
def test_dds_texture_draws_as_jax(fourcc, punch):
    ptex, port = _with_dds(port_sample, rt64tpu_torch, fourcc, punch,
                           device="cpu")
    jtex, jax_ = _with_dds(jax_sample, rt64tpu, fourcc, punch)
    assert np.array_equal(ptex.rgba, jtex.rgba)
    assert (ptex.width, ptex.height) == (32, 32)
    assert port[..., :3].std() > 1.0
    assert np.array_equal(port, jax_)
