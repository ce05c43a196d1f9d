"""Profiling and tracing: the observability the reference lacks.

The reference's only tracing is a breadcrumb log compiled out in
release (RT64_LOG_* macros, rt64_common.h:153-162). Here:

  * span(name): a host range at a layer boundary (`rt64.draw`,
    `rt64.scene.update`, `rt64.pack.geometry`, ...: README lists them).
    torch.profiler records it as a CPU event on its own clock, so a
    profile names the host's time, and the device's idle gaps, after
    the innermost span open. It is a FUNCTION-scope range: unlike
    record_function's USER-scope one it puts nothing on the device's
    timeline. Nesting in time gives each span its parent; a frame's
    spans lie inside its `rt64.draw`. About 1 us with no profiler on.
  * stage(name, device): a span that, while a torch profiler records,
    also times its interval on the device's current stream (two CUDA
    events, read after the present has waited for the frame or when
    the record is read; on the CPU, where torch ops are synchronous,
    the host clock) and adds it to the record.
  * upload(a, device): the per-frame host->device copy of the object
    model and the view driver; its bytes go to the record while a
    profiler records.
  * count_launch(name): one launch of a tracing wrapper
    (ops/tracer_cuda.py's K1-K4 and alpha sweep; on the CPU the call of
    its plain twin, the launch a card would make), added to the record
    while a profiler records.
  * count_reflection(live_rays, traced_lanes, skipped): what the
    reflection bounces of a frame traced (pipeline/framegraph.
    reflection_bounces: the live mirror rays of the bounces it issued,
    the lanes those bounces traced, and the bounces it did not issue for
    want of a live ray), added while a profiler records.
  * count_lights(pushed, shadow_lanes): the lights a frame's scene
    packing pushed (pipeline/scene_buffers.pack_frame) and the shadow
    lanes its light plans handed to the one batched shadow trace
    (ops/lighting.trace_plans), added while a profiler records.
  * frame_stats(): the record.
  * trace(): torch.profiler around a block, a chrome trace written
    into log_dir (with the spans).
  * stage_bench(): device time per step of `iters` steps back to back,
    between two CUDA events (the host clock on the CPU).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

# The tracing wrappers' launch counters (ops/tracer_cuda.LaunchCounts).
LAUNCHES = ("opaque_launches",  # K1
            "shadow_launches",  # K2
            "opaque_mt_launches",  # K3
            "shadow_mt_launches",  # K4
            "alpha_sweep_launches",  # alpha_sweep_kernel
            "hit_shade_launches",  # hit_shade_kernel
            "alpha_cull_launches")  # alpha_cull_kernel
# The reflection bounces' counters (count_reflection).
REFLECTION = ("reflection_live_rays",  # live mirror rays, summed over bounces
              "reflection_traced_lanes",  # lanes the issued bounces traced
              "reflection_bounces_skipped")  # bounces with no live ray
# The light loop's counters (count_lights).
LIGHTS = ("lights_pushed",  # lights in the packed scenes' light buffers
          "light_shadow_lanes")  # lanes the light plans' shadow rays take


def recording() -> bool:
    """True while a torch profiler records on this thread."""
    return _profiler_enabled()


def span(name: str):
    """A host range named `name` for torch.profiler (see the module
    docstring); use as `with span(name):`."""
    return _RecordFunctionFast(name)


class FrameRecord:
    """What the frames made while a torch profiler recorded: Device.draw
    calls (frames), render_frame calls (renders: alpha-boost re-renders
    and bands included), each stage's ms and calls, the bytes upload()
    copied, the tracing wrappers' launches (LAUNCHES), the reflection
    bounces' counters (REFLECTION) and the light loop's (LIGHTS). The
    whole process's, whatever thread added, under one lock like
    tracer_cuda.LaunchCounts."""

    _lock = threading.Lock()

    def __init__(self):
        self.reset()

    def reset(self):
        with self._lock:
            self.frames = 0
            self.renders = 0
            self.upload_bytes = 0
            self.counts = dict.fromkeys(LAUNCHES + REFLECTION + LIGHTS, 0)
            self.stage_ms = {}
            self.stage_calls = {}
            self._timed = []  # (name, device, start, end): events not yet read
            self._spare = {}  # device -> timing events to record again

    def add(self, frames: int = 0, renders: int = 0, upload_bytes: int = 0):
        with self._lock:
            self.frames += frames
            self.renders += renders
            self.upload_bytes += upload_bytes

    def add_count(self, name: str, amount: int = 1):
        with self._lock:
            self.counts[name] += amount

    def _add_stage(self, name: str, ms: float):
        self.stage_ms[name] = self.stage_ms.get(name, 0.0) + ms
        self.stage_calls[name] = self.stage_calls.get(name, 0) + 1

    def add_stage(self, name: str, ms: float):
        with self._lock:
            self._add_stage(name, ms)

    def events(self, device) -> list:
        """Two timing events for a stage on `device`, reused."""
        with self._lock:
            spare = self._spare.setdefault(device, [])
            if len(spare) >= 2:
                return [spare.pop(), spare.pop()]
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def add_timed(self, name: str, device, start, end):
        with self._lock:
            self._timed.append((name, device, start, end))

    def read_events(self, wait: bool = False):
        """Add the stages whose end event has passed (all of them, waiting
        for each, with wait) and keep their events for reuse. Without
        wait nothing here waits: an event query returns at once."""
        with self._lock:
            timed, self._timed = self._timed, []
        if wait:
            for _, _, _, end in timed:
                end.synchronize()
        with self._lock:
            for entry in timed:
                name, device, start, end = entry
                if end.query():
                    self._add_stage(name, start.elapsed_time(end))
                    self._spare.setdefault(device, []).extend((start, end))
                else:
                    self._timed.append(entry)

    def stats(self) -> dict:
        self.read_events(wait=True)
        with self._lock:
            return dict(frames=self.frames, renders=self.renders,
                        stage_ms=dict(self.stage_ms),
                        stage_calls=dict(self.stage_calls),
                        upload_bytes=self.upload_bytes, **self.counts)


record = FrameRecord()


@contextlib.contextmanager
def stage(name: str, device: torch.device):
    """A span; while a profiler records, also the ms of its interval on
    `device` (its current stream on a card: the time the stage holds
    the stream, which is its device time where the device paces the
    frame and its issue time where the host does), added to the record
    under `name`. Nothing here waits for the device."""
    timed = recording()
    on_card = timed and device.type == "cuda"
    if on_card:
        stream = torch.cuda.current_stream(device)
        start, end = record.events(device)
        start.record(stream)
    t0 = time.perf_counter()
    with _RecordFunctionFast(name):
        yield
    if on_card:
        end.record(stream)
        record.add_timed(name, device, start, end)
    elif timed:
        record.add_stage(name, (time.perf_counter() - t0) * 1e3)


def count_frame():
    """The end of a Device.draw: one frame while a profiler records, and
    the stage events that have passed are read (the present has waited
    for the frame; the rest are read later)."""
    if recording():
        record.add(frames=1)
        record.read_events()


def count_render():
    """One render_frame call while a profiler records."""
    if recording():
        record.add(renders=1)


def upload(a, device) -> torch.Tensor:
    """`a` (a numpy array or a host tensor) as a tensor on `device`. The
    object model's and the view driver's per-frame host->device copies
    come here; while a profiler records their bytes are counted (on the
    CPU, the bytes a card would take)."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    if recording():
        record.add(upload_bytes=t.nbytes)
    return t.to(device)


def count_launch(name: str):
    """One launch of the tracing wrapper counted under `name` (one of
    LAUNCHES) while a profiler records. Counts on the host alone: no
    launch, no wait."""
    if recording():
        record.add_count(name)


def count_reflection(live_rays: int, traced_lanes: int, skipped: int):
    """One reflection bounce's live mirror rays and the lanes it traced,
    or the bounces left out for want of a live ray (REFLECTION), while a
    profiler records. Host ints the caller already holds: no launch, no
    wait."""
    if recording():
        for name, amount in zip(REFLECTION,
                                (live_rays, traced_lanes, skipped)):
            record.add_count(name, amount)


def count_lights(pushed: int = 0, shadow_lanes: int = 0):
    """Lights pushed by a frame's scene packing, or the shadow lanes a
    batch of light plans hands to the shadow trace (LIGHTS), while a
    profiler records. Host ints the caller already holds: no launch, no
    wait."""
    if recording():
        record.add_count("lights_pushed", pushed)
        record.add_count("light_shadow_lanes", shadow_lanes)


def frame_stats() -> dict:
    """{frames, renders, stage_ms: {name: total ms}, stage_calls: {name:
    calls}, upload_bytes, and a count for each of LAUNCHES, REFLECTION
    and LIGHTS} made while a torch profiler recorded, since the process
    started or reset_frame_stats(). Waits for the stage events not yet
    read."""
    return record.stats()


def reset_frame_stats():
    record.reset()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler (CPU, and CUDA when there is a card) around a
    block; writes log_dir/trace.json (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _leaf(carry):
    while isinstance(carry, (tuple, list)):
        carry = carry[0]
    return carry


def stage_bench(name, step, init_carry, iters: int = 20, reps: int = 3):
    """ms per step of step: carry -> carry, run `iters` times back to back
    after one warm call, the mean over `reps` runs. On a CUDA
    carry the time is between two CUDA events on the current stream; on
    the CPU it is the host clock. `name` labels nothing here; it is kept
    for the JAX package's signature."""
    del name
    step(init_carry)
    cuda = isinstance(_leaf(init_carry), torch.Tensor) and _leaf(init_carry).is_cuda
    total = 0.0
    for _ in range(reps):
        carry = init_carry
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                carry = step(carry)
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                carry = step(carry)
            total += (time.perf_counter() - t0) * 1e3
    return total / reps / iters
