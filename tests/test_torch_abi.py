"""The port's C ABI against the JAX package's, on the CPU.

- The bridge's ctypes structs: the JAX bridge's fields, types, sizes and
  offsets.
- The sample host's calls replayed in Python (abi/hosts.py) through both
  bridges at 64x48: framebuffers at SSIM >= 0.99 (equal bytes are
  measured) and the same pick at the centre.
- Inspector commands through both bridges: the same replies, edits that
  land in the host's structs.
- The shim: librt64tpu_torch.so and both sample hosts built with g++
  into a temporary directory, run with RT64TPU_TORCH_DEVICE=cpu at
  64x48: each PPM equals, byte for byte, the frame of that host's calls
  replayed through the port's bridge in Python; sample_host_dl binds the
  library named by RT64TPU_LIBRARY (a path that does not exist fails).
- Without a card and without RT64TPU_TORCH_DEVICE, RT64_CreateDevice
  fails: in Python it raises, and a host prints the error from
  RT64_GetLastError and exits 1.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from rt64tpu.abi import bridge as jbridge

from rt64tpu_torch.abi import bridge as pbridge
from rt64tpu_torch.abi import build, hosts
from rt64tpu_torch.utils.assets import read_ppm
from rt64tpu_torch.utils.ssim import ssim

W, H = 64, 48
STRUCTS = ("Vec2", "Vec3", "Vec4", "Matrix4", "Rect", "CMaterial", "CLight",
           "CSceneDesc", "CViewDesc", "CInstanceDesc", "CTextureDesc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cpu_view(mp):
    """The bridges' environment of a headless host on the CPU at W x H."""
    mp.setenv("RT64TPU_VIEW_WIDTH", str(W))
    mp.setenv("RT64TPU_VIEW_HEIGHT", str(H))
    mp.setenv(pbridge.DEVICE_ENV, "cpu")


@pytest.fixture
def cpu_view(monkeypatch):
    _cpu_view(monkeypatch)


@pytest.fixture(scope="module")
def port_replay():
    """The sample host's calls through the port's bridge: (pixels, pick)."""
    with pytest.MonkeyPatch.context() as mp:
        _cpu_view(mp)
        return hosts.sample_host(pbridge)


def _layout(struct):
    return [(name, getattr(struct, name).offset, getattr(struct, name).size,
             ctypes.sizeof(ctype) if not hasattr(ctype, "_fields_")
             else ctype.__name__)
            for name, ctype in struct._fields_]


@pytest.mark.parametrize("name", STRUCTS)
def test_structs_match_jax_bridge(name):
    port, jax_ = getattr(pbridge, name), getattr(jbridge, name)
    assert ctypes.sizeof(port) == ctypes.sizeof(jax_)
    assert ctypes.alignment(port) == ctypes.alignment(jax_)
    assert [n for n, _ in port._fields_] == [n for n, _ in jax_._fields_]
    assert _layout(port) == _layout(jax_)


def test_sample_host_replay_matches_jax_bridge(cpu_view, port_replay):
    port, port_pick = port_replay
    jax_, jax_pick = hosts.sample_host(jbridge)
    assert port.shape == jax_.shape == (H, W, 4)
    assert port[..., :3].std() > 1.0
    assert ssim(port[..., :3], jax_[..., :3]) >= 0.99
    assert port_pick == jax_pick == "sphere"
    # Handles were released: the registries hold nothing of the replay.
    assert not pbridge._objects


def _command(bridge, inspector):
    def cmd(text):
        reply = ctypes.create_string_buffer(bridge.RT64TPU_INSPECTOR_REPLY_SIZE)
        line = ctypes.create_string_buffer(text.encode())
        handled = bridge.handle_message_inspector(
            inspector, bridge.RT64TPU_MESSAGE_COMMAND, ctypes.addressof(line),
            ctypes.addressof(reply))
        assert handled == 1
        return reply.value.decode()
    return cmd


SCRIPT = [
    "get material.solid_alpha_multiplier",
    "set material.solid_alpha_multiplier 0.25",
    "set material.specular_color 0.9 0.8 0.7",
    "get material.specular_color",
    "list material",
    "get material.bogus_field",
    "set light.0.diffuse_color 0 1 0",
    "get light.0.diffuse_color",
    "set scene.gi_sky_strength 0.5",
    "list scene",
    "print hello",
]


def test_inspector_commands_through_both_bridges(cpu_view):
    """test_abi_bridge.py's write-through test, through both bridges: the
    same replies, and each edit lands in the host's own structs."""
    results = []
    for bridge in (pbridge, jbridge):
        dev = bridge.create_device(0)
        ins = bridge.create_inspector(dev)
        mat = bridge.CMaterial()
        mat.solidAlphaMultiplier = 1.0
        mat.specularColor = bridge.Vec3(0.1, 0.2, 0.3)
        name = ctypes.create_string_buffer(b"sphere")
        bridge.set_material_inspector(ins, ctypes.addressof(mat),
                                      ctypes.addressof(name))
        lights = (bridge.CLight * 1)()
        lights[0].diffuseColor = bridge.Vec3(1, 1, 1)
        count = ctypes.c_int(1)
        bridge.set_lights_inspector(ins, ctypes.addressof(lights),
                                    ctypes.addressof(count), 8)
        desc = bridge.CSceneDesc()
        bridge.set_scene_inspector(ins, ctypes.addressof(desc))
        cmd = _command(bridge, ins)
        replies = [cmd(c) for c in SCRIPT]
        assert bridge.handle_message_inspector(ins, 0x111, 0, 0) == 0
        assert bridge._get(ins).messages == ["hello"]
        bridge.print_clear_inspector(ins)
        assert bridge._get(ins).messages == []
        results.append((replies, mat.solidAlphaMultiplier, mat.specularColor.tup(),
                        lights[0].diffuseColor.tup(), desc.giSkyStrength))
        bridge.destroy_inspector(ins)
        bridge.destroy_device(dev)
    assert results[0] == results[1]
    replies, alpha, specular, diffuse, gi_sky = results[0]
    assert replies[1] == "OK" and replies[5].startswith("ERR")
    assert alpha == np.float32(0.25) and diffuse == (0.0, 1.0, 0.0)
    assert specular == tuple(np.float32(v) for v in (0.9, 0.8, 0.7))
    assert gi_sky == np.float32(0.5)


def test_no_card_no_device(monkeypatch):
    """Without RT64TPU_TORCH_DEVICE the bridge draws on the card only;
    with no card it raises rather than draw on the CPU."""
    monkeypatch.delenv(pbridge.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=pbridge.DEVICE_ENV):
        pbridge.create_device(0)
    monkeypatch.setenv(pbridge.DEVICE_ENV, "cpu")
    dev = pbridge.create_device(0)
    assert pbridge._get(dev).device == torch.device("cpu")
    pbridge.destroy_device(dev)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the shim")
    try:
        build.python_config()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    return build.build(str(tmp_path_factory.mktemp("abi")))


def test_shim_hosts_equal_their_replays(shim, cpu_view, port_replay, tmp_path):
    env = {pbridge.DEVICE_ENV: "cpu", "OMP_NUM_THREADS": "1"}
    ppm = str(tmp_path / "sample_host.ppm")
    run = build.run_host(shim.sample_host, ppm, W, H, env=env)
    assert run.returncode == 0, run.stderr
    assert "picked instance at center: sphere" in run.stdout
    replay, pick = port_replay
    assert pick == "sphere"
    assert np.array_equal(read_ppm(ppm), replay[..., :3])

    ppm = str(tmp_path / "sample_host_dl.ppm")
    run = build.run_host(shim.sample_host_dl, ppm, W, H,
                         env=dict(env, RT64TPU_LIBRARY=shim.library))
    assert run.returncode == 0, run.stderr
    assert "library bound via pointer table" in run.stdout
    assert np.array_equal(read_ppm(ppm), hosts.sample_host_dl(pbridge)[..., :3])

    missing = str(tmp_path / "no" / "librt64tpu_torch.so")
    run = build.run_host(shim.sample_host_dl, ppm, W, H,
                         env=dict(env, RT64TPU_LIBRARY=missing))
    assert run.returncode == 1 and missing in run.stderr


def test_shim_without_a_card_fails(shim, tmp_path, monkeypatch):
    """The embedded bridge finds no card: CreateDevice returns NULL and
    the host prints RT64_GetLastError (CUDA_VISIBLE_DEVICES hides a card
    where there is one)."""
    monkeypatch.delenv(pbridge.DEVICE_ENV, raising=False)
    run = build.run_host(shim.sample_host, str(tmp_path / "x.ppm"), W, H,
                         env={"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert run.returncode == 1
    assert "CreateDevice failed" in run.stderr and pbridge.DEVICE_ENV in run.stderr
    assert not (tmp_path / "x.ppm").exists()


def test_build_embeds_this_interpreter_and_checkout(shim):
    """The shim is built for the interpreter and the checkout that built
    it, and its cache key covers the commands."""
    import sys

    lib_cmd = build._commands("@")[build.LIBRARY]
    assert f'-DRT64TPU_TORCH_PYTHON="{sys.executable}"' in lib_cmd
    assert f'-DRT64TPU_TORCH_ROOT="{build.ROOT}"' in lib_cmd
    assert shim.seconds > 0 and "rt64_abi.cpp" in shim.log
    assert build._digest(build._commands("@")) == build._digest(build._commands("@"))
