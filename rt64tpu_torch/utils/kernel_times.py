"""Time the packet-traversal kernels of two trees on the same launches.

    python3 -m rt64tpu_torch.utils.kernel_times capture LAUNCHES [--config castle-refl]
    python3 rt64tpu_torch/utils/kernel_times.py time LAUNCHES --root DIR \\
        --tag NAME [--outputs FILE]
    python3 -m rt64tpu_torch.utils.kernel_times compare FILE FILE

capture draws the frames whose launches chip_smoke.py holds (the castle
640x480 frame, a castle GI 1280x720 frame and a large-castle GI 1280x720
frame, each after one settling draw), records the kernel wrappers'
calls and saves eight launches with their inputs (torch.save):
  k1, k2: the castle frame's primary and direct-light shadow launches;
  k1_bounce, k2_bounce: the castle GI frame's regrouped bounce launches
    (its last closest-hit and last occlusion launch);
  k3, k3_bounce, k4, k4_bounce: the large-castle GI frame's primary,
    bounce, direct-light shadow and bounce-shadow launches.
These frames draw with max_reflections 0. capture --config castle-refl
saves the reflection launches instead, of the two GI frames drawn with
max_reflections 2 (bench config 4 at native size):
  k1_refl1, k1_refl2: the castle GI frame's first and second reflection
    bounces (its third and fourth closest-hit launches, after the
    primary and the regrouped GI bounce; k1_refl2 only where the second
    bounce has a live mirror ray, for a bounce without one is not
    launched);
  k3_refl1: the large-castle GI frame's first reflection bounce.
time imports rt64tpu_torch from --root (a checkout of any tree, e.g. an
older commit unpacked with git archive), builds that tree's kernels and
times its wrappers on the saved launches (CUDA events around each call,
median of 25, as chip_smoke.py times them; and the mean of 25 calls
issued back to back, where the host's issue time hides behind the
device's work; the host time of issuing a call; and each kernel's
device time under torch.profiler; and, by the tree's own chip_smoke.py,
the launch's counted work and bound), with
the keyword inputs its wrappers take (a tree whose K1/K2 take no packed
table is given none). It prints one JSON line and, with --outputs, saves
the outputs. compare holds two such output files against each other:
bit-equal outputs per launch, else the share of equal triangle ids (or
flags). Needs a CUDA card; the numbers are what `chip_smoke.py` prints
as PREV_MS when the other tree is the parent commit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

WRAPPERS = {"k1": "trace_opaque_blocks", "k2": "trace_shadow_blocks",
            "k3": "trace_opaque_mt_blocks", "k4": "trace_shadow_mt_blocks"}
FLOPS = {"k1": "FLOPS_K1", "k2": "FLOPS_K2", "k3": "FLOPS_K3", "k4": "FLOPS_K4"}


def _capture(path, config):
    import torch

    from rt64tpu_torch.ops import tracer_cuda as tc
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    reflections = 2 if config == "castle-refl" else 0

    def launches_of(width, height, **kw):
        dev, _, view = build_castle_scene(width, height, di_samples=1, **kw)
        view.max_reflections = reflections
        dev.draw()  # settles the alpha boost ladder, fills the history
        seen = {k: [] for k in WRAPPERS}
        originals = {k: getattr(tc, name) for k, name in WRAPPERS.items()}

        def recorder(k):
            def rec(*args, **kwargs):
                seen[k].append((args, kwargs))
                return originals[k](*args, **kwargs)
            return rec

        for k, name in WRAPPERS.items():
            setattr(tc, name, recorder(k))
        try:
            dev.draw()
        finally:
            for k, name in WRAPPERS.items():
                setattr(tc, name, originals[k])
        torch.cuda.synchronize()
        return seen

    largest = lambda calls: max(calls, key=lambda c: c[0][0].shape[1])
    out = {}
    if reflections:
        # primary, GI bounce, then one launch per reflection bounce
        seen = launches_of(1280, 720, gi_samples=1, denoiser=True)
        if len(seen["k1"]) not in (3, 4):
            raise SystemExit(f"castle-refl launched K1 {len(seen['k1'])} times")
        for b, call in enumerate(seen["k1"][2:], 1):
            out[f"k1_refl{b}"] = call
        seen = launches_of(1280, 720, gi_samples=1, denoiser=True,
                           terrain_n=128)
        if len(seen["k3"]) not in (3, 4):
            raise SystemExit(f"castle-refl launched K3 {len(seen['k3'])} times")
        out["k3_refl1"] = seen["k3"][2]
    else:
        seen = launches_of(640, 480, gi_samples=0)
        out["k1"], out["k2"] = seen["k1"][-1], seen["k2"][-1]
        seen = launches_of(1280, 720, gi_samples=1, denoiser=True)
        out["k1_bounce"], out["k2_bounce"] = seen["k1"][-1], seen["k2"][-1]
        seen = launches_of(1280, 720, gi_samples=1, denoiser=True,
                           terrain_n=128)
        out["k3"], out["k3_bounce"] = seen["k3"][0], seen["k3"][-1]
        out["k4"], out["k4_bounce"] = largest(seen["k4"]), seen["k4"][-1]
    torch.save({k: (tuple(a), dict(kw)) for k, (a, kw) in out.items()}, path)
    print(json.dumps({"captured": {k: int(v[0][0].shape[1])
                                   for k, v in out.items()}}), flush=True)


def _time_ms(fn, reps=25, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def batched_ms(fn, reps=25):
    """Mean device time of fn() over `reps` calls issued back to back
    between one pair of CUDA events: the host runs ahead, so a launch's
    host time hides behind the device's work unless it is the longer."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps=25):
    """Median host time of issuing fn() to an idle card (no wait for the
    card): the part of a call's time that the device does not set."""
    import time

    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _device_ms(fn, reps=5):
    """Device time per call of each kernel fn() launches, ms, from
    torch.profiler's CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            out[e.key[:48]] = us / reps / 1e3
    return out


def _bound(smoke, name, args, out, wrapper, kw):
    """The launch's counted work and bound, by the tree's own
    chip_smoke.py (its counting instantiation, stage flops and byte
    count)."""
    import torch

    from rt64tpu_torch.ops import tracer_cuda as tc

    counts = args[3]
    stats = torch.empty((counts.shape[0], tc.STATS_COLS), dtype=torch.int64,
                        device=counts.device)
    wrapper(*args, stats=stats, **kw)
    torch.cuda.synchronize()
    work = smoke.counted_work(stats, getattr(smoke, FLOPS[name[:2]]))
    n_bytes = sum(a.numel() * a.element_size() for a in args[:5])
    n_bytes += sum(o.numel() * o.element_size() for o in out)
    work["bound_ms"], work["bound_by"] = smoke.bound_ms(n_bytes, work["flops"])
    return work


def _time(path, tag, outputs, root):
    import torch

    from rt64tpu_torch.ops import tracer_cuda as tc

    if not os.path.abspath(tc.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {tc.__file__}, not the tree at {root}")

    lib = tc.kernel_library()
    launches = torch.load(path, map_location="cuda")
    row = {"tag": tag, "root": root,
           "ptxas": [l.strip() for l in lib.ptxas_log.splitlines()
                     if "registers" in l or "spill" in l]}
    import chip_smoke as smoke  # the tree's own, at its root

    saved = {}
    for name, (args, kw) in launches.items():
        wrapper = getattr(tc, WRAPPERS[name[:2]])
        takes = inspect.signature(wrapper).parameters
        kw = {k: v for k, v in kw.items() if k in takes}
        out = wrapper(*args, **kw)
        torch.cuda.synchronize()
        saved[name] = tuple(o.cpu() for o in (
            out if isinstance(out, tuple) else (out,)))
        call = lambda: wrapper(*args, **kw)
        med, lo, hi = _time_ms(call)
        row[name] = {"ms": med, "ms_min": lo, "ms_max": hi,
                     "ms_batched": batched_ms(call),
                     "host_ms": _host_ms(call),
                     "device_ms": _device_ms(call),
                     **_bound(smoke, name, args, saved[name], wrapper, kw)}
    if outputs:
        torch.save(saved, outputs)
    print(json.dumps(row), flush=True)


def _compare(a_path, b_path):
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    row = {}
    for name in a:
        same = all(torch.equal(x, y) for x, y in zip(a[name], b[name]))
        ids_a, ids_b = a[name][1 if len(a[name]) > 1 else 0], \
            b[name][1 if len(b[name]) > 1 else 0]
        row[name] = {"bit_equal": same,
                     "ids_agree": (ids_a == ids_b).float().mean().item()}
    print(json.dumps({"compare": [a_path, b_path], **row}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("capture")
    c.add_argument("launches")
    c.add_argument("--config", choices=("default", "castle-refl"),
                   default="default")
    t = sub.add_parser("time")
    t.add_argument("launches")
    t.add_argument("--tag", required=True)
    t.add_argument("--root", default=".")
    t.add_argument("--outputs", default=None)
    m = sub.add_parser("compare")
    m.add_argument("a")
    m.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "time":
        # Import the package of the tree at --root (so run `time` as a
        # file, not with -m, which imports this file's tree first).
        launches = os.path.abspath(args.launches)
        outputs = args.outputs and os.path.abspath(args.outputs)
        root = os.path.abspath(args.root)
        os.chdir(root)
        sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cmd == "capture":
        _capture(args.launches, args.config)
    elif args.cmd == "time":
        _time(launches, args.tag, outputs, root)
    else:
        _compare(args.a, args.b)


if __name__ == "__main__":
    main()
