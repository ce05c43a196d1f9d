"""Where a frame's time goes on the card: profile castle frames drawn
through Device.draw() with torch.profiler and print one JSON line.

    python3 -m rt64tpu_torch.utils.frame_profile [--width 640 --height 480 --frames 5]
    python3 -m rt64tpu_torch.utils.frame_profile --config large-gi
    python3 -m rt64tpu_torch.utils.frame_profile --config castle-refl
    python3 -m rt64tpu_torch.utils.frame_profile --config castle-raster
    python3 -m rt64tpu_torch.utils.frame_profile --config castle-refl-fsr --upscale-block
    python3 -m rt64tpu_torch.utils.frame_profile --config bench5

--config castle (the default) is the castle frame without GI; large-gi
is the large castle (terrain_n 128, beyond the packet tracer's size
switch) at 1280x720 with gi_samples 1 and the denoiser; castle-gi is the
castle at 1280x720 with gi_samples 1 and the denoiser; castle-refl is
castle-gi with two reflection bounces (bench config 4 at native size);
castle-raster is castle-refl with the castle's sky plane removed and
testscenes.raster_layers drawn over it: a raster-background skybox and a
HUD of 12 textured quads (the frame of a game that draws its own skybox
and HUD); castle-refl-fsr is castle-refl with the FSR slot in auto mode
(render 960x552, upscaled to 1280x720); bench5 is bench config 5 as
bench.py writes it: the castle at 3840x2160 with gi_samples 1 (denoiser
off), two reflection bounces and the DLSS slot in performance mode
(render 1920x1080). castle-refl, castle-raster, castle-refl-fsr and
bench5 draw with max_reflections 2, the others with 0.

Reports the median wall time per frame without the profiler and under
it, the summed device-kernel time per frame (and so the device's idle
share, against the profiled frames' wall time), the kernel launch count
per frame, the peak device memory and the kernels with the most device
time; if the warm-up draws run out of device memory, one JSON line with
the point (the port's last lines on the stack) and the peak, exit 1.
--upscale-block also times the block after compose (upscale,
RCAS, motion blur) on the last frame's outputs, once per upscaler slot
at the frame's render and display sizes: device ms between CUDA events
(median of 10) and launches (torch.profiler). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
import traceback


# name -> ((width, height), build_castle_scene keywords, max_reflections,
# raster layers, ViewDesc fields: (upscaler, upscaler_mode) names)
CONFIGS = {
    "castle": ((640, 480), dict(gi_samples=0), 0, False, None),
    "large-gi": ((1280, 720),
                 dict(gi_samples=1, denoiser=True, terrain_n=128), 0, False,
                 None),
    "castle-gi": ((1280, 720), dict(gi_samples=1, denoiser=True), 0, False,
                  None),
    "castle-refl": ((1280, 720), dict(gi_samples=1, denoiser=True), 2, False,
                    None),
    "castle-raster": ((1280, 720), dict(gi_samples=1, denoiser=True), 2,
                      True, None),
    "castle-refl-fsr": ((1280, 720), dict(gi_samples=1, denoiser=True), 2,
                        False, ("UPSCALER_FSR", "UPSCALER_MODE_AUTO")),
    "bench5": ((3840, 2160), dict(gi_samples=1), 2, False,
               ("UPSCALER_DLSS", "UPSCALER_MODE_PERFORMANCE")),
}


def build_config(name, width=None, height=None, device=None):
    """(dev, scene, view) of one configuration of CONFIGS."""
    from rt64tpu_torch import descriptors as d
    from rt64tpu_torch.utils.castle_scene import build_castle_scene
    from rt64tpu_torch.utils.testscenes import raster_layers

    (w, h), scene_kw, reflections, layers, upscaler = CONFIGS[name]
    dev, scene, view = build_castle_scene(width or w, height or h,
                                          di_samples=1, device=device,
                                          **scene_kw)
    view.max_reflections = reflections
    if layers:
        view.set_sky_plane(None)
        raster_layers(scene, dev)
    if upscaler:
        view.desc.upscaler = getattr(d, upscaler[0])
        view.desc.upscaler_mode = getattr(d, upscaler[1])
    return dev, scene, view


def upscale_block(view, reps=10):
    """Device ms (CUDA events, median of `reps`) and launches of the
    block after compose (framegraph.upscale, then motion blur) on the
    view's last frame, once per upscaler slot at the frame's render and
    display sizes; the FSR slot also with RCAS and with motion blur."""
    import dataclasses
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rt64tpu_torch import descriptors as d
    from rt64tpu_torch.models import upscaler as ups
    from rt64tpu_torch.ops import filters
    from rt64tpu_torch.pipeline import framegraph as fg

    r = view._renderer
    out, cfg = r._last, r._last_cfg
    g = out.gbuffers
    gp = r._global_params(cfg)._replace(
        upscaler_sharpness=torch.tensor(0.5, device=r.device),
        motion_blur_strength=torch.tensor(0.5, device=r.device))
    dh, dw = cfg.display_height, cfg.display_width
    slots = {
        "off_bilinear": dict(upscaler=d.UPSCALER_OFF),
        "fsr": dict(upscaler=d.UPSCALER_FSR),
        "xess": dict(upscaler=d.UPSCALER_XESS),
        "dlss": dict(upscaler=d.UPSCALER_DLSS),
        "fsr_rcas": dict(upscaler=d.UPSCALER_FSR, sharpen_enabled=True),
        "fsr_motion_blur": dict(upscaler=d.UPSCALER_FSR,
                                motion_blur_enabled=True),
    }
    rows = {}
    for name, fields in slots.items():
        c = dataclasses.replace(cfg, **{"sharpen_enabled": False,
                                        "motion_blur_enabled": False,
                                        **fields})
        channels = ups.temporal_channels(c.upscaler)
        history = (torch.rand((channels, dh, dw), device=r.device)
                   if channels else None)

        def block():
            disp, _ = fg.upscale(c, gp, g, out.rt_output, history)
            if c.motion_blur_enabled:
                flow = filters.bilinear_resize(fg.to_image(c, g.flow), dh, dw)
                disp = filters.motion_blur(
                    disp, flow, (float(c.rt_width), float(c.rt_height)),
                    gp.motion_blur_strength, c.motion_blur_samples)
            return disp

        block()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            block()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            block()
            torch.cuda.synchronize()
        rows[name] = dict(
            ms=statistics.median(times), ms_min=min(times),
            launches=sum(1 for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA))
    return dict(render=(cfg.rt_width, cfg.rt_height), display=(dw, dh),
                slots=rows)


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="castle")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--upscale-block", action="store_true",
                    help="also time the upscale block per upscaler slot")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile needs a CUDA card")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    (width, height), _, reflections, _, _ = CONFIGS[args.config]
    args.width = args.width or width
    args.height = args.height or height
    dev, _, view = build_config(args.config, args.width, args.height)
    try:
        for _ in range(2):  # warm up: kernel build, boost ladder, allocator
            dev.draw()
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as exc:
        # Where the frame ran out: the last line of the port it ran.
        where = [f"{f.filename.split('rt64tpu_torch/')[-1]}:{f.lineno} {f.line}"
                 for f in traceback.extract_tb(exc.__traceback__)
                 if "rt64tpu_torch" in f.filename]
        cfg = view._renderer._config()
        print(json.dumps(dict(
            card=smi, config=args.config, width=args.width,
            height=args.height, render_width=cfg.rt_width,
            render_height=cfg.rt_height,
            alpha_boost=view._renderer.alpha_boost,
            out_of_memory=str(exc).splitlines()[0], where=where[-3:],
            max_memory_allocated=torch.cuda.max_memory_allocated())))
        raise SystemExit(1)

    torch.cuda.reset_peak_memory_stats()
    plain = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        dev.draw()
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)

    wall = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.frames):
            t0 = time.perf_counter()
            dev.draw()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    us = lambda e: e.time_range.elapsed_us()
    device_ms = sum(us(e) for e in kernels) / 1e3 / args.frames
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + us(e) / 1e3 / args.frames, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
    frame_ms = statistics.median(wall)
    peak = torch.cuda.max_memory_allocated()
    cfg = view._renderer._config()
    block = upscale_block(view) if args.upscale_block else None
    print(json.dumps(dict(
        card=smi, config=args.config, width=args.width, height=args.height,
        render_width=cfg.rt_width, render_height=cfg.rt_height,
        upscaler=cfg.upscaler, alpha_boost=view._renderer.alpha_boost,
        max_reflections=reflections, frames=args.frames,
        frame_ms_median_unprofiled=statistics.median(plain),
        frame_ms_unprofiled=plain,
        frame_ms_median=frame_ms, device_kernel_ms_per_frame=device_ms,
        device_idle_share=max(0.0, 1.0 - device_ms / frame_ms),
        kernel_launches_per_frame=len(kernels) / args.frames,
        max_memory_allocated=peak,
        top_kernels=[dict(name=n[:120], ms_per_frame=t, launches=c // args.frames)
                     for n, (t, c) in top],
        upscale_block=block,
    )))


if __name__ == "__main__":
    main()
