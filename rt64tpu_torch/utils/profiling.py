"""Profiling and tracing: the observability the reference lacks.

The reference's only tracing is a breadcrumb log compiled out in
release (RT64_LOG_* macros, rt64_common.h:153-162). Here:

  * FrameTimer: wall time per stage, synchronising the device of a
    CUDA tensor the stage names, for coarse breakdowns.
  * trace(): torch.profiler around a block, a chrome trace written
    into log_dir.
  * stage_bench(): device time per step of `iters` steps back to back,
    between two CUDA events (the host clock on the CPU).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch


def _sync(tensors):
    """Wait for the CUDA devices that hold any tensor in `tensors` (a
    tensor or a nested tuple/list of them)."""
    if isinstance(tensors, torch.Tensor):
        if tensors.is_cuda:
            torch.cuda.synchronize(tensors.device)
    elif isinstance(tensors, (tuple, list)):
        for t in tensors:
            _sync(t)


class FrameTimer:
    """Accumulates per-stage wall times; report() prints a table."""

    def __init__(self):
        self.times = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            _sync(sync_on)
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [f"{'stage':<28}{'ms':>10}{'%':>7}"]
        for name, t in self.times.items():
            lines.append(f"{name:<28}{t * 1e3:>10.2f}{100 * t / total:>6.1f}%")
        return "\n".join(lines)


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
