"""Headline benchmark of the port: frames/sec and Mrays/s on the BASELINE
ladder, on the CUDA card. The counterpart of the repository's bench.py
(the JAX package's), with the same configs, arguments and JSON line:

    python3 -m rt64tpu_torch.bench                 # climb the ladder
    python3 -m rt64tpu_torch.bench --config 4 --streamed
    python3 -m rt64tpu_torch.bench --config 5 --ssim

It prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"},
"ladder" in ladder mode, "ssim_vs_native" with --ssim, and the card's
name and power limit as nvidia-smi reads them ("card"). vs_baseline is
the measured fps / 60 (the BASELINE.md target). It needs a card: the
functions below take device= for tests on the CPU, main() does not.

Rungs are measured on the production path: with an upscaler, the frame
renders at the quality table's internal resolution and upscales to the
display in-frame; --native turns the upscaler off.

- measure: device-chained frames, the torch form of bench.py's lax.scan:
  render_frame called directly with frame_count and the Halton jitter
  advancing each frame and the history and temporal state carried, no
  present readback, one synchronize at the end of a rep.
- measure_streamed: the host loop a game runs (StreamedLoop): per-frame
  descriptor pushes and Device.draw(), with the present ring on.
- measure_ssim: the production frame against a native-resolution one;
  above 4.5 Mpixel the native frame is drawn in 4 bands of rows
  (native_banded, at alpha boost 1, as bench.py draws it), and the alpha
  hits those bands drop are returned with the SSIM.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

# BASELINE.md config ladder presets:
# (scene, display_w, display_h, di, gi, reflections, upscaler, mode).
CONFIGS = {
    1: ("sample", 320, 240, 1, 0, 0, "off", "auto"),
    2: ("castle", 640, 480, 1, 0, 0, "fsr", "auto"),
    3: ("castle", 1280, 720, 1, 1, 0, "fsr", "auto"),
    4: ("castle", 1280, 720, 1, 1, 2, "fsr", "auto"),
    5: ("castle", 3840, 2160, 1, 1, 2, "dlss", "performance"),
}

UPSCALERS = {"off": 0x0, "auto": 0x1, "dlss": 0x2, "fsr": 0x3, "xess": 0x4}
MODES = {
    "auto": 0x0, "ultra_performance": 0x1, "performance": 0x2,
    "balanced": 0x3, "quality": 0x4, "ultra_quality": 0x5, "native": 0x6,
}
# measure_ssim draws the native reference in bands above this size.
BANDED_PIXELS = 4_500_000
NATIVE_BANDS = 4


def build(scene_name, width, height, di, gi, reflections, upscaler="off",
          mode="auto", device=None):
    """(dev, scene, view) of one rung, the renderer created. device: None
    for the CUDA card."""
    if scene_name == "castle":
        from rt64tpu_torch.utils.castle_scene import build_castle_scene

        dev, scene, view = build_castle_scene(
            width=width, height=height, di_samples=di, gi_samples=gi,
            device=device)
    else:
        from rt64tpu_torch.utils.testscenes import build_sample_scene

        dev, scene, view = build_sample_scene(
            width=width, height=height, di_samples=di, gi_samples=gi,
            device=device)
    view.max_reflections = reflections
    view.set_description(dataclasses.replace(
        view.desc, upscaler=UPSCALERS[upscaler], upscaler_mode=MODES[mode]))
    view.update()
    return dev, scene, view


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(scene_name, width, height, di, gi, reflections, frames, reps,
            upscaler="off", mode="auto", device=None):
    """(fps, cfg, has_lit_transparent) for one rung: `frames` device-chained
    frames a rep, timed over `reps` reps after one warm rep."""
    from rt64tpu_torch import descriptors as d
    from rt64tpu_torch.models import upscaler as ups
    from rt64tpu_torch.ops import math3d
    from rt64tpu_torch.pipeline import framegraph as fg

    dev, scene, view = build(scene_name, width, height, di, gi, reflections,
                             upscaler, mode, device)
    r = view._renderer
    cfg = r._config()
    gp = r._global_params(cfg)
    bg = r._background_planes(cfg)
    scaling = (cfg.display_height, cfg.display_width) != (cfg.rt_height,
                                                          cfg.rt_width)
    channels = ups.temporal_channels(cfg.upscaler) if scaling else 0
    # frame_count drives every noise fetch and the jitter phase advances,
    # as in a host loop: a constant frame would let nothing change.
    if cfg.upscaler != d.UPSCALER_OFF:
        phases = ups.jitter_phase_count(cfg.rt_width, cfg.display_width,
                                        upscaler=cfg.upscaler)
        jitter = [math3d.halton_jitter(f, phases) for f in range(frames)]
    else:
        jitter = [(0.0, 0.0)] * frames
    if channels:
        gp = gp._replace(temporal_reset=torch.zeros((), dtype=torch.bool,
                                                    device=r.device))

    def run():
        hist = fg.History.zeros(cfg.rt_height, cfg.rt_width, r.device)
        temporal = (torch.zeros((channels, cfg.display_height,
                                 cfg.display_width), device=r.device)
                    if channels else None)
        means = []
        for i in range(frames):
            gpi = gp._replace(frame_count=(gp.frame_count + i) & 0xFFFFFFFF,
                              pixel_jitter=tuple(float(v) for v in jitter[i]))
            o = fg.render_frame(r._sb, gpi, hist, r.bn_table, cfg,
                                bg_planes=bg, temporal=temporal)
            hist, temporal = o.history, o.temporal
            means.append(o.image.mean())
        _sync(r.device)
        return torch.stack(means)

    run()  # warm: kernel build, tables, allocator
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    dt = (time.perf_counter() - t0) / (reps * frames)
    return 1.0 / dt, cfg, bool(r._sb.features.has_lit_transparent)


class StreamedLoop:
    """bench.py's streamed host loop over a built rung: push(f) turns
    instance 1 by 0.03 f radians about y (keeping its previous
    transform), pushes the camera again (hosts re-push it every frame)
    and draws."""

    def __init__(self, dev, scene, view):
        self.dev, self.scene, self.view = dev, scene, view
        self.inst = scene.instances[min(1, len(scene.instances) - 1)]
        tf = self.inst.desc.transform
        self.base_tf = (np.eye(4, dtype=np.float32) if tf is None
                        else np.asarray(tf, np.float32).reshape(4, 4))

    def push(self, f):
        from rt64tpu_torch.ops import math3d

        de, view = self.inst.desc, self.view
        de.previous_transform = de.transform
        de.transform = math3d.rotation_y(0.03 * f) @ self.base_tf
        self.inst.set_description(de)
        view.set_perspective(view.view_matrix, view.fov_radians,
                             view.near_dist, view.far_dist, True)
        self.dev.draw()


def measure_streamed(scene_name, width, height, di, gi, reflections,
                     frames, reps, upscaler="off", mode="auto", device=None):
    """(fps, cfg, has_lit_transparent) of the host loop with the present
    ring on: `frames` warm draws, then `reps` reps of the same angle
    cycle (new angles could climb the alpha boost ladder mid-loop), the
    device drained at the end."""
    dev, scene, view = build(scene_name, width, height, di, gi, reflections,
                             upscaler, mode, device)
    r = view._renderer
    r.pipelined = True
    loop = StreamedLoop(dev, scene, view)
    for f in range(frames):
        loop.push(f)
    _sync(r.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        for f in range(frames):
            loop.push(f)
    _sync(r.device)
    dt = (time.perf_counter() - t0) / (reps * frames)
    return 1.0 / dt, r._config(), bool(r._sb.features.has_lit_transparent)


def native_banded(scene_name, width, height, di, gi, reflections, bands,
                  frames, device=None):
    """The native frame (upscaler off) drawn in `bands` bands of rows
    through tiling.sharded_render, `frames` frames from zero history with
    the history concatenated across the bands, at a fresh renderer's
    config (alpha boost 1, as bench.py draws it): (the last frame's RGB8
    image (H, W, 3) numpy, the alpha hits dropped in each frame). The
    bands are drawn in turn on `device`."""
    from rt64tpu_torch.parallel import tiling
    from rt64tpu_torch.pipeline import framegraph as fg

    _, _, view = build(scene_name, width, height, di, gi, reflections, "off",
                       "auto", device)
    r = view._renderer
    cfg = r._config()
    bg = r._background_planes(cfg)
    gp0 = r._global_params(cfg)
    render = tiling.sharded_render(cfg, bands)
    hist = fg.History.zeros(cfg.rt_height, cfg.rt_width, r.device)
    drops = []
    for f in range(frames):
        gp = gp0._replace(frame_count=torch.tensor(f, device=r.device))
        out = render(r._sb, gp, hist, r.bn_table, bg)
        hist = out.history
        drops.append(int(out.alpha_dropped))
        image = fg.present_rgb8(out.image)
        del out
    return image.cpu().numpy(), drops


def final_image(scene_name, width, height, di, gi, reflections, upscaler,
                mode, frames, device=None):
    """The presented RGB8 frame (H, W, 3) after `frames` Device.draw()s."""
    dev, _, view = build(scene_name, width, height, di, gi, reflections,
                         upscaler, mode, device)
    for _ in range(frames):
        dev.draw()
    return view.framebuffer()[..., :3].copy()


def measure_ssim(scene_name, width, height, di, gi, reflections, upscaler,
                 mode, frames=8, device=None):
    """(SSIM of the production frame against the native one, the alpha
    hits the banded native reference dropped per frame: [] when it was
    drawn whole)."""
    from rt64tpu_torch.utils.ssim import ssim

    rung = (scene_name, width, height, di, gi, reflections)
    prod = final_image(*rung, upscaler, mode, frames, device)
    if width * height > BANDED_PIXELS:
        native, drops = native_banded(*rung, NATIVE_BANDS, frames, device)
    else:
        native, drops = final_image(*rung, "off", "auto", frames, device), []
    return ssim(prod.astype(np.float64) / 255.0,
                native.astype(np.float64) / 255.0, data_range=1.0), drops


def rung_mrays(cfg, fps, has_lit_transparent=True):
    """Mrays/s from the rays the frame graph traces for this config:
    primary 1, DI shadows max_lights x di, the lit-transparent shadow di
    when the scene can make one, GI gi x (1 + di), refraction (1 + di)
    when on, and max_reflections."""
    di = cfg.di_samples
    rays_per_pixel = (
        1
        + cfg.max_lights * di
        + (di if has_lit_transparent else 0)
        + cfg.gi_samples * (1 + di)
        + ((1 + di) if cfg.refraction_enabled else 0)
        + cfg.max_reflections
    )
    return cfg.rt_width * cfg.rt_height * rays_per_pixel * fps / 1e6


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=sorted(CONFIGS), default=None,
                    help="BASELINE.md ladder rung; default: climb the ladder "
                         "and headline the frontier (first rung under 60 fps)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--di", type=int, default=None)
    ap.add_argument("--gi", type=int, default=None)
    ap.add_argument("--reflections", type=int, default=None)
    ap.add_argument("--target-fps", type=float, default=60.0)
    ap.add_argument("--scene", choices=["sample", "castle"], default=None)
    ap.add_argument("--native", action="store_true",
                    help="force the upscaler off (render at display size)")
    ap.add_argument("--upscaler", choices=sorted(UPSCALERS), default=None)
    ap.add_argument("--quality", choices=sorted(MODES), default=None)
    ap.add_argument("--ssim", action="store_true",
                    help="also the SSIM of the production frame against a "
                         "native-size one")
    ap.add_argument("--streamed", action="store_true",
                    help="the host loop (descriptor pushes, Device.draw, the "
                         "present ring), not device-chained frames")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rt64tpu_torch.bench measures the CUDA card and "
                         "finds none")
    smi = card()

    if args.config is None and args.scene is None and args.width is None:
        ladder, frontier = {}, None
        for c in sorted(CONFIGS):
            scene_name, w, h, di, gi, refl, ups, md = CONFIGS[c]
            if args.native:
                ups, md = "off", "auto"
            fps, cfg, tl = measure(scene_name, w, h, di, gi, refl,
                                   args.frames, args.reps, ups, md)
            ladder[f"config{c}"] = round(fps, 2)
            frontier = (c, scene_name, w, h, di, gi, refl, ups, cfg, fps, tl)
            if fps < args.target_fps:
                break
        c, scene_name, w, h, di, gi, refl, ups, cfg, fps, tl = frontier
        mrays = rung_mrays(cfg, fps, tl)
        print(json.dumps({
            "metric": f"fps@{w}x{h} (BASELINE frontier config {c}: "
                      f"{scene_name} scene, di={di} gi={gi} refl={refl}, "
                      f"{ups} {cfg.rt_width}x{cfg.rt_height} internal; "
                      f"{mrays:.0f} Mrays/s; ladder "
                      + ",".join(f"{k}={v}" for k, v in ladder.items()) + ")",
            "value": round(fps, 2),
            "unit": "frames/sec",
            "vs_baseline": round(fps / args.target_fps, 3),
            "ladder": ladder,
            "card": smi,
        }))
        return

    config = args.config if args.config is not None else 1
    c_scene, c_w, c_h, c_di, c_gi, c_refl, c_ups, c_mode = CONFIGS[config]
    pick = lambda v, default: default if v is None else v
    scene_name, w, h = (pick(args.scene, c_scene), pick(args.width, c_w),
                        pick(args.height, c_h))
    di, gi, refl = (pick(args.di, c_di), pick(args.gi, c_gi),
                    pick(args.reflections, c_refl))
    ups, mode = pick(args.upscaler, c_ups), pick(args.quality, c_mode)
    if args.native:
        ups, mode = "off", "auto"

    meas = measure_streamed if args.streamed else measure
    fps, cfg, tl = meas(scene_name, w, h, di, gi, refl, args.frames, args.reps,
                        ups, mode)
    mrays = rung_mrays(cfg, fps, tl)
    loop = "streamed " if args.streamed else ""
    out = {
        "metric": f"fps@{w}x{h} ({loop}BASELINE config {config}: {scene_name} "
                  f"scene, di={di} gi={gi} refl={refl}, {ups} "
                  f"{cfg.rt_width}x{cfg.rt_height} internal; "
                  f"{mrays:.0f} Mrays/s)",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / args.target_fps, 3),
        "card": smi,
    }
    if args.ssim and ups != "off":
        s, drops = measure_ssim(scene_name, w, h, di, gi, refl, ups, mode)
        out["ssim_vs_native"] = round(s, 4)
        out["native_alpha_dropped"] = drops
    print(json.dumps(out))


if __name__ == "__main__":
    main()
