"""The port's bench module (rt64tpu_torch.bench) on the CPU, at small
sizes: the ladder and the ray count are bench.py's, and each loop runs
and returns what bench.py's does. Its numbers here are CPU numbers and
stand nowhere; main() refuses to measure without a card."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from rt64tpu_torch import bench
from rt64tpu_torch.pipeline import framegraph as fg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ladder_and_ray_count_are_bench_py(jax_bench):
    assert bench.CONFIGS == jax_bench.CONFIGS
    assert bench.UPSCALERS == jax_bench.UPSCALERS
    assert bench.MODES == jax_bench.MODES
    cfg = fg.RenderConfig(rt_width=96, rt_height=64, display_width=128,
                          display_height=96, di_samples=2, gi_samples=1,
                          max_lights=3, max_reflections=2,
                          refraction_enabled=True)
    for tl in (True, False):
        assert bench.rung_mrays(cfg, 37.5, tl) == jax_bench.rung_mrays(cfg, 37.5, tl)


@pytest.mark.parametrize("upscaler,size", [("off", (64, 48)),
                                           ("fsr", (128, 96))])
def test_measure_chains_frames(upscaler, size):
    fps, cfg, _ = bench.measure("sample", *size, 1, 0, 0, 2, 1, upscaler,
                                "auto", device="cpu")
    assert fps > 0
    assert (cfg.display_width, cfg.display_height) == size
    rendered = cfg.rt_width * cfg.rt_height
    assert (rendered < size[0] * size[1]) == (upscaler == "fsr")


def test_streamed_loop_with_the_ring():
    fps, cfg, _ = bench.measure_streamed("sample", 64, 48, 1, 0, 0, 3, 1,
                                         device="cpu")
    assert fps > 0 and (cfg.rt_width, cfg.rt_height) == (64, 48)


def test_banded_native_equals_drawn_frames():
    """The banded reference's loop (2 bands) gives the frames that
    Device.draw() presents for the same rung, and measure_ssim compares
    the production frame with it."""
    rung = ("sample", 64, 48, 1, 0, 0)
    image, drops = bench.native_banded(*rung, 2, 2, device="cpu")
    drawn = bench.final_image(*rung, "off", "auto", 2, device="cpu")
    assert drops == [0, 0]
    assert image.shape == (48, 64, 3) and np.array_equal(image, drawn)
    s, drops = bench.measure_ssim(*rung, "fsr", "auto", frames=2, device="cpu")
    assert 0.0 < s < 1.0 and drops == []


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        bench.main(["--config", "1"])
