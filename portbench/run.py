"""Run one cell of BENCHMARK.json once and print its result line:

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.

Set-up (counted in setup_s, from process start to the first timed
frame): the scene made from the seed and pushed through the port's
object model, then the traffic's warm-up frames of the same walk (the
kernel library built or loaded, the alpha-boost ladder climbed). The
window: frames of the walk, each its pushes, Device.draw() and the
presented frame read back, until --seconds have passed. Then the check:
the last frame's outputs copied to the host, the port's state freed, and
the plain reference run on the card (check.py).

--trace 0 prints the cell's end-to-end metrics. --trace 1 runs the
window in three parts (Scene.update on the host clock; torch's
sync-debug mode; torch.profiler, at most 40 frames or 5 s once 3 frames
are in) and prints the per-layer metrics, busy_s and window_s, and a
breakdown.

The last line of standard output is one JSON object: correct, attempted
(frames in the window), failed (checked frames not correct), metrics,
device, in a traced run breakdown, and last checks (each number
compared with its limit, also printed as the last lines of standard
error). Exit codes: 0 a result; 2 no such cell, configuration or mix,
or a mix whose loop or present mode the harness does not drive; 3 no
CUDA card, or fewer than the cell asks for; 4 JAX or the JAX package
loaded in this process.
"""

from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_START = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "rt64tpu")
SYNC_PART, PROFILE_MAX_FRAMES, PROFILE_MIN_FRAMES, PROFILE_CAP_S = 1 / 3, 40, 3, 5.0


def cache_env(root: str):
    """Before torch is imported: every build and kernel cache inside the
    checkout, at fixed paths (the port builds its kernel library into
    build/rt64tpu_torch/ by itself)."""
    base = os.path.join(root, "build", "portbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


class Cell:
    """One run of a cell: the program built from the seed, its walk, and
    the frame loop."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from portbench import program, scene, walk

        walk.check_modes(traffic)
        self.cfg, self.traffic = cfg, traffic
        self.data = scene.build_scene(cfg["scene"], traffic["character"], seed)
        self.walk = walk.Walk(traffic, self.data, seed)
        self.prog = program.build(self.data, cfg, device)
        self.next = 0  # the next frame of the walk
        self.states = [None, None]  # the walk's frames before and last drawn
        self.boost_changed = False

    def frame(self) -> float:
        """One frame: pushes, draw, present. Its host seconds."""
        from portbench import program

        state = self.walk.frame(self.next)
        r = self.prog.renderer
        boost = None if r is None else r.alpha_boost
        t0 = time.perf_counter()
        program.push(self.prog, state, self.traffic["camera"])
        program.draw(self.prog)
        t1 = time.perf_counter()
        self.boost_changed = boost != self.prog.renderer.alpha_boost
        self.states = [self.states[1], state]
        self.next += 1
        return t1 - t0

    def frames_for(self, seconds: float, at_least: int = 1, at_most=None,
                   wrap=None):
        """Frames until `seconds` have passed (and at least `at_least`):
        (per-frame seconds, the wall seconds of them all)."""
        times = []
        start = time.perf_counter()
        while True:
            times.append(self.frame() if wrap is None else wrap(self.frame))
            now = time.perf_counter()
            if len(times) >= at_least and (
                    now - start >= seconds
                    or (at_most is not None and len(times) >= at_most)):
                return times, now - start


def window_metrics(times, wall) -> dict:
    import statistics

    ms = [t * 1e3 for t in times]
    p95 = (statistics.quantiles(ms, n=100, method="inclusive")[94]
           if len(ms) > 1 else ms[0])
    return dict(frame_ms=wall * 1e3 / len(times), frame_ms_p95=p95)


def traced_window(cell: Cell, seconds: float, device):
    """The traced window: (TraceData without the reference's part,
    frames run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    with open(os.path.join(ROOT, "portbench", "peaks.json")) as fh:
        peaks = json.load(fh).get(torch.cuda.get_device_name(device))
    td = trace.TraceData(cfg=cell.cfg, triangles=cell.data.triangles(),
                         hit_share=None, peaks=peaks)
    clock = trace.SceneUpdateClock(cell.prog.scene)
    clock.on = True
    part = seconds * SYNC_PART
    t1, _ = cell.frames_for(part)
    clock.on = False
    td.scene_update_ms = clock.ms
    (t2, _), sites = trace.count_syncs(lambda: cell.frames_for(part))
    td.sync_frames, td.sync_sites = len(t2), sites

    def in_range(fn):
        with record_function(trace.FRAME_RANGE):
            return fn()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t3, _ = cell.frames_for(min(part, PROFILE_CAP_S), PROFILE_MIN_FRAMES,
                                PROFILE_MAX_FRAMES, wrap=in_range)
        torch.cuda.synchronize(device)
    td.frames, td.kernels, td.host = trace.profiled_events(prof)
    return td, len(t1) + len(t2) + len(t3)


def run(bench, cell_name: str, seed: int, seconds: float, traced: bool,
        device=None, with_control: bool = False) -> dict:
    """One run of a cell; returns the result line's object. device: the
    program's torch device (None: the first CUDA card). with_control:
    also judge the control, the reference computed a step below the
    stated precision in the program's place, under "control"
    (calibrate.py and the tests; the benchmark's own runs do not run
    it)."""
    import torch

    from portbench import check, program, trace

    wl = bench.workload(cell_name)
    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    dev = torch.device("cuda:0" if device is None else device)
    on_card = dev.type == "cuda"
    cell = Cell(cfg, traffic, seed, dev)
    for _ in range(cell.walk.warmup_frames):
        cell.frame()
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - PROCESS_START

    result_metrics, td, breakdown = {}, None, None
    if traced:
        td, attempted = traced_window(cell, seconds, dev)
    else:
        times, wall = cell.frames_for(seconds)
        attempted = len(times)
        result_metrics = window_metrics(times, wall)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    for _ in range(4):
        if not cell.boost_changed:
            break
        # The last frame climbed the alpha-boost ladder: its re-render
        # took the upscale slot's state on by a step, so the check takes
        # the next frame of the walk, drawn after the window.
        cell.frame()
    check_start = time.perf_counter()
    planes = program.outputs(cell.prog)
    (prev_state, state), data = cell.states, cell.data
    del cell
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    pixels = check.sample_pixels(cfg, data, state, traffic["camera"], seed,
                                 cfg["check"]["uniform"],
                                 cfg["check"]["character"])
    want = check.reference_frame(data, state, prev_state, cfg,
                                 traffic["camera"], pixels, planes, dev,
                                 root=ROOT)
    numbers = check.compare(check.at_pixels(planes, pixels), want, state.eye)
    if tuple(planes["render"]) != tuple(cfg["render"]):
        numbers = {k: check.FAILED for k in numbers}
    correct, rows = check.judge(numbers, cfg["limits"])
    control_out = None
    if with_control:
        ctl = check.reference_frame(
            data, state, prev_state, cfg, traffic["camera"], pixels, planes,
            dev, dtype=torch.bfloat16, upscale_dtype=torch.bfloat16,
            net_dtype=torch.float8_e4m3fn, root=ROOT)
        ctl_numbers = check.compare(ctl, want, state.eye)
        ok, ctl_rows = check.judge(ctl_numbers, cfg["limits"])
        control_out = dict(correct=ok, checks=ctl_rows, numbers=ctl_numbers)

    if traced:
        td.hit_share = want["hit_share"]
        for m in bench.per_layer(cell_name):
            value = bench.reader(m["name"]).read(td)
            if value is not None:
                result_metrics[m["name"]] = dict(value=value, unit=m["unit"])
        breakdown = trace.breakdown(td) if td.frames else None
        sites = sorted(td.sync_sites.items(), key=lambda kv: -kv[1])
        print("host syncs over %d frames: %s" % (td.sync_frames, json.dumps(sites)),
              file=sys.stderr)
    else:
        result_metrics["peak_mem_gb"] = peak / 1e9
        result_metrics["setup_s"] = setup_s
        result_metrics = {m["name"]: dict(value=result_metrics[base],
                                          unit=m["unit"])
                          for m in bench.end_to_end(cell_name)
                          for base in [bench.base_name(m["name"],
                                                       result_metrics)]}

    out = dict(correct=bool(correct), attempted=attempted,
               failed=0 if correct else 1, metrics=result_metrics,
               device=dict(platform="gpu" if on_card else dev.type,
                           kind=(torch.cuda.get_device_name(dev) if on_card
                                 else "cpu"),
                           count=int(wl["chips"]), memory_peak_bytes=peak))
    if traced:
        out["device"]["busy_s"] = trace.busy_us(td.kernels) / 1e6
        out["device"]["window_s"] = td.window_us / 1e6
        if breakdown is not None:
            out["breakdown"] = breakdown
    if control_out is not None:
        out["control"] = control_out
        out["numbers"] = numbers
        out["check_s"] = time.perf_counter() - check_start
    out["checks"] = rows
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)

    from portbench.harness import Benchmark, UnknownName

    bench = Benchmark(ROOT)
    try:
        chips = int(bench.workload(args.workload)["chips"])
    except UnknownName as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        raise SystemExit(2)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        raise SystemExit(3)
    try:
        out = run(bench, args.workload, args.seed, args.seconds,
                  bool(args.trace))
    except UnknownName as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        raise SystemExit(2)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the run may not load: {bad}",
              file=sys.stderr)
        raise SystemExit(4)
    print(f"card: {card_line()}", file=sys.stderr)
    for name, row in out["checks"].items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
