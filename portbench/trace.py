"""The traced run's instruments and the arithmetic that reduces them.

Spans and counters come from the benchmark's own files, around the
calls into the port's layers:
- host clock around Scene.update as Device.draw calls it;
- torch's sync-debug mode over whole frames, the synchronising calls
  counted by file:line (the port's chip_smoke.count_syncs, copied);
- torch.profiler over whole frames, each in a `portbench.frame` range:
  device kernels with their intervals, and the host's ranges for what
  it was doing while the device idled.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import heapq
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

FRAME_RANGE = "portbench.frame"
# An idle gap in which no profiled host range was open: the host ran
# Python (or numpy) between the port's torch calls.
HOST_CODE = "(host code between profiled ops)"
Interval = Tuple[str, float, float]  # name, start us, end us


@dataclasses.dataclass
class TraceData:
    """What the per-layer readers read (one traced run)."""

    cfg: dict  # the configuration file
    triangles: int  # the scene's triangles, as the benchmark pushed them
    hit_share: Optional[float]  # the reference's share of sampled pixels hit
    peaks: Optional[dict]  # the card's row of peaks.json, None if absent
    scene_update_ms: List[float] = dataclasses.field(default_factory=list)
    sync_frames: int = 0
    sync_sites: Dict[str, int] = dataclasses.field(default_factory=dict)
    frames: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    kernels: List[Interval] = dataclasses.field(default_factory=list)
    host: List[Interval] = dataclasses.field(default_factory=list)

    @property
    def window_us(self) -> float:
        return self.frames[-1][1] - self.frames[0][0] if self.frames else 0.0

    def frame_kernels(self):
        """Per profiled frame, its device kernels in start order."""
        ks = sorted(self.kernels, key=lambda k: k[1])
        starts = [k[1] for k in ks]
        return [ks[bisect.bisect_left(starts, a):bisect.bisect_left(starts, b)]
                for a, b in self.frames]


class SceneUpdateClock:
    """Host ms of every Scene.update call while on (wraps the bound
    method of one Scene object)."""

    def __init__(self, scene):
        self.ms: List[float] = []
        self.on = False
        inner = scene.update

        def timed():
            if not self.on:
                return inner()
            t0 = time.perf_counter()
            try:
                return inner()
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)

        scene.update = timed


def count_syncs(fn):
    """(fn(), {"file:line": count} of the synchronizing CUDA calls it
    made), as torch's sync-debug mode reports them."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return out, dict(sites)


def profiled_events(prof):
    """(frames [(start, end)], kernels [Interval], host [Interval]) in
    microseconds on the profiler's clock."""
    import torch

    frames, kernels, host = [], [], []
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name == FRAME_RANGE:
            # The range also shows on the device's timeline, as an
            # annotation over the frame's kernels: only the host's counts.
            if e.device_type == torch.autograd.DeviceType.CPU:
                frames.append(iv[1:])
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append(iv)
        else:
            host.append(iv)
    frames.sort()
    if frames:
        a, b = frames[0][0], frames[-1][1]
        kernels = [k for k in kernels if k[1] >= a and k[2] <= b]
    return frames, kernels, host


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_us(kernels: List[Interval]) -> float:
    return sum(b - a for a, b in merged((k[1], k[2]) for k in kernels))


def gaps(kernels: List[Interval], start: float, end: float):
    """The idle (start, end) intervals of [start, end] between kernels."""
    out, t = [], start
    for a, b in merged((k[1], k[2]) for k in kernels):
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
    if t < end:
        out.append((t, end))
    return out


def label_gaps(host: List[Interval], spans) -> List[str]:
    """For each (start, end) span, in start order, the innermost host
    range open at its midpoint: a sweep with the open ranges in a heap by
    length, those that ended popped when they come to its top."""
    host = sorted(host, key=lambda h: h[1])
    heap, i, out = [], 0, []
    for a, b in spans:
        m = (a + b) / 2
        while i < len(host) and host[i][1] <= m:
            name, s, e = host[i]
            heapq.heappush(heap, (e - s, i, name, e))
            i += 1
        while heap and heap[0][3] < m:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else HOST_CODE)
    return out


def breakdown(td: TraceData, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    time by what the host was doing, each [name, seconds]."""
    by_op = collections.Counter()
    for name, a, b in td.kernels:
        by_op[name[:160]] += (b - a) / 1e6
    idle = gaps(td.kernels, td.frames[0][0], td.frames[-1][1])
    by_host = collections.Counter()
    for (a, b), name in zip(idle, label_gaps(td.host, idle)):
        by_host[name] += (b - a) / 1e6
    return dict(device_ops=[[n, s] for n, s in by_op.most_common(top)],
                idle_gaps=[[n, s] for n, s in by_host.most_common(top)])
