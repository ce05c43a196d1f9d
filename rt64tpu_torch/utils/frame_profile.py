"""Where a frame's time goes on the card: profile castle frames drawn
through Device.draw() with torch.profiler and print one JSON line.

    python3 -m rt64tpu_torch.utils.frame_profile [--width 640 --height 480 --frames 5]
    python3 -m rt64tpu_torch.utils.frame_profile --config large-gi
    python3 -m rt64tpu_torch.utils.frame_profile --config castle-refl
    python3 -m rt64tpu_torch.utils.frame_profile --config castle-raster

--config castle (the default) is the castle frame without GI; large-gi
is the large castle (terrain_n 128, beyond the packet tracer's size
switch) at 1280x720 with gi_samples 1 and the denoiser; castle-gi is the
castle at 1280x720 with gi_samples 1 and the denoiser; castle-refl is
castle-gi with two reflection bounces (bench config 4 at native size);
castle-raster is castle-refl with the castle's sky plane removed and
testscenes.raster_layers drawn over it: a raster-background skybox and a
HUD of 12 textured quads (the frame of a game that draws its own skybox
and HUD). castle-refl and castle-raster draw with max_reflections 2, the
others with 0.

Reports the median wall time per frame without the profiler and under
it, the summed device-kernel time per frame (and so the device's idle
share, against the profiled frames' wall time), the kernel launch count
per frame, the peak device memory and the kernels with the most device
time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time


# name -> ((width, height), build_castle_scene keywords, max_reflections,
# raster layers)
CONFIGS = {
    "castle": ((640, 480), dict(gi_samples=0), 0, False),
    "large-gi": ((1280, 720),
                 dict(gi_samples=1, denoiser=True, terrain_n=128), 0, False),
    "castle-gi": ((1280, 720), dict(gi_samples=1, denoiser=True), 0, False),
    "castle-refl": ((1280, 720), dict(gi_samples=1, denoiser=True), 2, False),
    "castle-raster": ((1280, 720), dict(gi_samples=1, denoiser=True), 2, True),
}


def build_config(name, width=None, height=None, device=None):
    """(dev, scene, view) of one configuration of CONFIGS."""
    from rt64tpu_torch.utils.castle_scene import build_castle_scene
    from rt64tpu_torch.utils.testscenes import raster_layers

    (w, h), scene_kw, reflections, layers = CONFIGS[name]
    dev, scene, view = build_castle_scene(width or w, height or h,
                                          di_samples=1, device=device,
                                          **scene_kw)
    view.max_reflections = reflections
    if layers:
        view.set_sky_plane(None)
        raster_layers(scene, dev)
    return dev, scene, view


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="castle")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile needs a CUDA card")

    (width, height), _, reflections, _ = CONFIGS[args.config]
    args.width = args.width or width
    args.height = args.height or height
    dev, _, view = build_config(args.config, args.width, args.height)
    for _ in range(2):  # warm up: kernel build, boost ladder, allocator
        dev.draw()
    torch.cuda.synchronize()

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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    frame_ms = statistics.median(wall)
    print(json.dumps(dict(
        card=smi, config=args.config, width=args.width, height=args.height,
        max_reflections=reflections, frames=args.frames,
        frame_ms_median_unprofiled=statistics.median(plain),
        frame_ms_unprofiled=plain,
        frame_ms_median=frame_ms, device_kernel_ms_per_frame=device_ms,
        device_idle_share=max(0.0, 1.0 - device_ms / frame_ms),
        kernel_launches_per_frame=len(kernels) / args.frames,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        top_kernels=[dict(name=n[:120], ms_per_frame=t, launches=c // args.frames)
                     for n, (t, c) in top],
    )))


if __name__ == "__main__":
    main()
