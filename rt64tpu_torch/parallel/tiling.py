"""Row tiling: a frame drawn as horizontal bands of rows.

A band is the frame graph run on a band config (shard_config: the
band's rows, the whole frame's full_height) at its first row
(render_frame's row_offset). Screen-space math reads the whole grid, the
blue noise and the sky plane follow the global row, and reprojection
reads the whole frame's history, so the bands, stacked, are the whole
frame: exactly while the denoiser is off; with it on, the GI filter
sees only its band's rows, so rows within cfg.gi_filter_passes of a band
edge differ (as in the JAX package's sharded frame).

The JAX package shards the bands over a device mesh (shard_map: the
scene, camera, blue noise, background and history replicated, the pixel
planes sharded by row, alpha_dropped summed with psum, one all-gather of
the history a frame). PyTorch has no mesh: sharded_render takes a list
of devices and gives each entry one worker thread; band b runs on
devices[b % len(devices)], in that entry's worker. A worker makes its
device the thread's current one and issues its bands in turn on its own
stream, so the host issues the bands at once: the kernel launches
(ctypes) and most torch ops release the GIL, and a worker's host syncs
wait for its own stream only. The workers still share the one GIL,
which each takes back after every eager op: with many small ops a band
issues no faster, and the handoffs cost more the more workers there are
(PERF.md has the measured cost). The inputs live on the home device,
devices[0]; the workers, the entries that draw a band (devices[:n_bands]),
get copies on their devices (replicate_inputs, replicate_history: the
all-gather's counterpart), and an entry past the band count is sent
nothing. The bands' outputs come back to the home device in band order
(gather_bands). Entries may repeat a device: on one card the bands
still run side by side, each on its own stream. devices=None draws the
bands one after another on the inputs' device, on the calling thread
(bench.py's native 4K reference on one card, where the whole frame does
not fit).
"""

from __future__ import annotations

import threading
from contextlib import ExitStack
from dataclasses import replace
from typing import NamedTuple, Optional

import torch

from rt64tpu_torch.devices import indexed
from rt64tpu_torch.ops import tracer_cuda
from rt64tpu_torch.pipeline import framegraph as fg
from rt64tpu_torch.pipeline.scene_buffers import SceneBuffers, scene_buffers_to
from rt64tpu_torch.utils import profiling


def shard_config(cfg: fg.RenderConfig, n_bands: int) -> fg.RenderConfig:
    """A band's config: rt_height and display_height divided by n_bands,
    full_height the whole frame's rows."""
    if cfg.full_height:
        raise ValueError("the config is a band already")
    if cfg.rt_height % n_bands or cfg.display_height % n_bands:
        raise ValueError(
            f"{n_bands} bands do not divide {cfg.rt_height} render rows "
            f"and {cfg.display_height} display rows")
    return replace(cfg, rt_height=cfg.rt_height // n_bands,
                   display_height=cfg.display_height // n_bands,
                   full_height=cfg.rt_height)


def _entries(devices):
    """The entries of `devices` as indexed devices (a bare "cuda" is the
    calling thread's current card, not a worker's)."""
    entries = [indexed(d) for d in devices]
    if not entries:
        raise ValueError("devices is empty: give at least one device")
    if len({d.type for d in entries}) != 1:
        raise ValueError(f"devices mix device types: {entries}")
    return entries


def _map(fn, x):
    """fn applied to every tensor of a tree of NamedTuples; other leaves
    (None, host floats) as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    return x


def _tensors(x):
    found = []
    _map(found.append, x)
    return found


def stack_bands(parts):
    """Bands' values of one output, stacked on the pixel or row axis: 1-D
    planes on axis 0, (C, N) planes and (C, H, W) images on axis 1;
    scalars (the alpha-drop counts) summed; None stays None."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):  # History, GBuffers
        return type(first)(*(stack_bands(list(f)) for f in zip(*parts)))
    if first.ndim == 0:
        return sum(parts[1:], first)
    return torch.cat(parts, dim=0 if first.ndim == 1 else 1)


def _stack(outs):
    return fg.FrameOutputs(*(stack_bands(list(f)) for f in zip(*outs)))


class FrameInputs(NamedTuple):
    """What every band reads whole, on one device."""

    sb: SceneBuffers
    gp: fg.GlobalParams
    bn_table: torch.Tensor
    bg_planes: Optional[torch.Tensor]


def replicate_inputs(inputs: FrameInputs, devices) -> dict:
    """{device: the inputs on it} for each distinct device of `devices`:
    on the inputs' own device the inputs themselves, on each other one
    copy (non-blocking)."""
    return {
        d: FrameInputs(
            scene_buffers_to(inputs.sb, d), fg.global_params_to(inputs.gp, d),
            inputs.bn_table.to(d, non_blocking=True),
            None if inputs.bg_planes is None
            else inputs.bg_planes.to(d, non_blocking=True))
        for d in dict.fromkeys(devices)
    }


def replicate_history(history: fg.History, devices) -> tuple:
    """The whole frame's history on every entry of `devices` (None: the
    history's own device), one History per entry: entries on one device
    share one copy, and on the history's own device it is the history
    itself. Reprojection reads across band edges, so every band needs the
    whole of it. sharded_render's fn takes the copies for its workers
    only, the entries that draw a band: pass devices[:n_bands] (fn
    refuses copies for an entry past the band count)."""
    entries = [history.depth.device] if devices is None else _entries(devices)
    per_device = {d: fg.history_to(history, d) for d in dict.fromkeys(entries)}
    return tuple(per_device[d] for d in entries)


def _histories(history, workers) -> tuple:
    """fn's history argument as one History per worker (an entry that
    draws a band): a History is replicated to the workers only;
    replicate_history's copies must be the workers', one each, and are
    checked."""
    if isinstance(history, fg.History):
        return replicate_history(history, workers)
    history = tuple(history)
    if (len(history) != len(workers)
            or any(h.depth.device != d for h, d in zip(history, workers))):
        raise ValueError(
            "history must be one History or replicate_history's copies "
            f"for the entries that draw a band, one each: {workers}")
    return history


def gather_bands(outs, home: torch.device, done=()):
    """The bands' FrameOutputs, in band order, as one FrameOutputs on
    `home` (stack_bands of every output: alpha_dropped the sum over the
    bands). done: CUDA events recorded after the bands' work on their
    workers' streams. Every stream that reads a band's tensors here (the
    current stream of the tensor's device: the stack on the home card, a
    copy from any other) waits on them first, and the caching allocator
    keeps a band's blocks until those reads end (record_stream)."""
    if home.type == "cuda":
        tensors = [t for out in outs for t in _tensors(out)]
        for d in dict.fromkeys(t.device for t in tensors):
            stream = torch.cuda.current_stream(d)
            for event in done:
                stream.wait_event(event)
        for t in tensors:
            t.record_stream(torch.cuda.current_stream(t.device))
    return _stack([_map(lambda t: t.to(home, non_blocking=True), out)
                   for out in outs])


def _recorded_event(stream):
    event = torch.cuda.Event()
    event.record(stream)
    return event


def sharded_render(cfg: fg.RenderConfig, n_bands: int, devices=None,
                   visualization_mode: int = 0):
    """fn(sb, gp, history, bn_table, bg_planes) -> FrameOutputs of the
    whole frame, drawn in n_bands bands of cfg's rows.

    history covers the whole frame in the bands' pixel order (the
    previous call's output history, or History.zeros of the whole frame).
    fn copies it to the workers only, the entries that draw a band
    (devices[:n_bands]); an entry past the band count gets no copy. It
    may also be replicate_history(history, devices[:n_bands])'s copies;
    copies for any other list of entries (every entry of a list longer
    than n_bands, say) raise ValueError naming the workers. bg_planes
    is the whole frame's (3, H, W) base plane. Per-pixel outputs are the
    bands' concatenated (to_image_banded reads them as images),
    alpha_dropped their sum.

    devices: None draws the bands in turn on the inputs' device. A list
    draws band b on devices[b % len(devices)], one worker thread per
    entry (see the module docstring), with the inputs and the result on
    devices[0]. A worker that raises makes fn raise once every worker
    has stopped; no frame is returned then."""
    band = shard_config(cfg, n_bands)
    entries = None if devices is None else _entries(devices)
    # Each worker's stream, made at the first call and kept: the caching
    # allocator reuses a block only on the stream that freed it, so a
    # fresh stream every frame would leave each frame's blocks idle.
    streams = []

    def draw(b, inputs, history):
        return fg.render_frame(inputs.sb, inputs.gp, history, inputs.bn_table,
                               band, visualization_mode=visualization_mode,
                               bg_planes=inputs.bg_planes,
                               row_offset=b * band.rt_height)

    def fn(sb, gp, history, bn_table, bg_planes):
        inputs = FrameInputs(sb, gp, bn_table, bg_planes)
        if entries is None:
            (history,) = _histories(history, [gp.view.device])
            return _stack([draw(b, inputs, history) for b in range(n_bands)])
        home = entries[0]
        if gp.view.device != home:
            raise ValueError(f"the inputs are on {gp.view.device}, "
                             f"devices[0] is {home}")
        workers = entries[:n_bands]
        histories = _histories(history, workers)
        per_device = replicate_inputs(inputs, workers)
        card = home.type == "cuda"
        if card:
            # Build or load the kernels here, not in a worker.
            tracer_cuda.kernel_library()
            if not streams:
                streams.extend(torch.cuda.Stream(d) for d in workers)
            ready = {d: _recorded_event(torch.cuda.current_stream(d))
                     for d in per_device}
        outs = [None] * n_bands
        done = []
        errors = [None] * len(workers)
        stop = threading.Event()
        recording = profiling.recording()

        def work(i):
            dev = workers[i]
            try:
                with ExitStack() as on:
                    on.enter_context(profiling.inherit_recording(recording))
                    if card:
                        on.enter_context(torch.cuda.device(dev))
                        on.enter_context(torch.cuda.stream(streams[i]))
                        streams[i].wait_event(ready[dev])
                    for b in range(i, n_bands, len(entries)):
                        if stop.is_set():
                            return
                        outs[b] = draw(b, per_device[dev], histories[i])
                    if card:
                        done.append(_recorded_event(streams[i]))
            except BaseException as exc:  # raised again by fn, below
                errors[i] = exc
                stop.set()

        threads = [threading.Thread(target=work, args=(i,),
                                    name=f"band worker {i} ({d})")
                   for i, d in enumerate(workers)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        failed = [exc for exc in errors if exc is not None]
        if failed:
            if card:  # the failed frame's work ends before its memory is reused
                for stream in streams:
                    stream.synchronize()
            raise failed[0]
        return gather_bands(outs, home, done)

    return fn


def to_image_banded(cfg: fg.RenderConfig, n_bands: int, plane):
    """(C, N) or (N,) plane of a frame drawn in n_bands bands -> (C, H, W)
    or (H, W): each band undoes its own pixel order (a band may be
    untiled where the whole frame is tiled)."""
    band = shard_config(cfg, n_bands)
    parts = torch.chunk(plane, n_bands, dim=plane.ndim - 1)
    return torch.cat([fg.to_image(band, p) for p in parts],
                     dim=0 if plane.ndim == 1 else 1)
