"""ViewRenderer: drives the frame graph for an api.View.

The View::update / View::render split of the reference
(rt64_view.cpp:1053-1178 / :1180-1667): update() assembles scene
buffers (instance classification + uploads), render() runs the frame
and retains the outputs for presentation and picking, and carries the
temporal upscaler's display-size history from frame to frame.

Full sync (the reference's model, rt64_device.cpp:1006-1025): the frame
reads its alpha-overflow scalar and its RGB8 present back before draw
returns. Pipelined: frame N presents frame N - depth, and nothing of
the frame in flight is read back: its present and drop scalar are
copied to pinned host buffers behind it and read once its event has
passed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rt64tpu_torch import descriptors as d
from rt64tpu_torch.convert import global_params_from_numpy
from rt64tpu_torch.models import upscaler as ups
from rt64tpu_torch.ops import bluenoise, filters, math3d
from rt64tpu_torch.pipeline import framegraph as fg
from rt64tpu_torch.pipeline.scene_buffers import ScenePacker
from rt64tpu_torch.utils import profiling
from rt64tpu_torch.utils.log import breadcrumb

MAX_ALPHA_BOOST = 16


class PickPlanes(NamedTuple):
    """The planes of a presented frame that picking and the Inspector's
    gizmos read, in the frame's pixel order."""

    instance: torch.Tensor  # (N,) int32
    position: torch.Tensor  # (3, N)


class _InFlight(NamedTuple):
    """One frame in the present ring: its RGB8 present and alpha-drop
    count on the host (pinned on the card, filled behind the frame until
    `event` has passed), and its picking planes. Not the whole
    FrameOutputs: two frames in flight would hold every g-buffer."""

    rgb: torch.Tensor  # (DH, DW, 3) uint8
    dropped: torch.Tensor  # () int64
    event: Optional[torch.cuda.Event]
    pick: PickPlanes
    cfg: fg.RenderConfig


def _pinned(shape, dtype) -> torch.Tensor:
    buf = torch.empty(shape, dtype=dtype, pin_memory=True)
    if not buf.is_pinned():
        raise RuntimeError("the present ring needs pinned host memory")
    return buf


class ViewRenderer:
    """pipelined is read at every render, so a host may flip it on a live
    renderer; pipeline_depth is the frames a present trails its draw (the
    JAX package's argument; every caller uses its default, 2)."""

    def __init__(self, view, pipelined: bool = False, pipeline_depth: int = 2):
        self.view = view
        self.pipelined = pipelined
        self.pipeline_depth = max(1, pipeline_depth)
        self._pending = []  # _InFlight, oldest first
        self._spare = []  # popped frames' pinned buffers, for reuse
        device = view.scene.device
        self.device = device.device
        self.packer = ScenePacker(device.limits, self.device)
        self.bn_table = torch.from_numpy(bluenoise.packed_table()).to(self.device)
        self.history: Optional[fg.History] = None
        self.active_instances = []
        self._sb = None
        self._sky_rec = -1
        self._temporal = None  # the temporal upscaler's history (display size)
        self._prev_view_proj = None
        self._prev_view_i = None
        self._last = None  # the newest frame's FrameOutputs
        self._last_cfg = None
        self._prev_image = None  # the frame before it's display image
        self._alpha_boost = 1
        self._pick_src = None  # (PickPlanes, cfg) of the presented frame
        self._pick_plane = None  # cached on-demand picking readback
        self._bg_cache = {}  # (h, w) -> the black base plane on the device

    # -- update: the View::update analog -----------------------------------
    def update(self):
        view = self.view
        scene = view.scene
        # Instance classification (rt64_view.cpp:1081-1147): raytraced
        # instances feed the tracer; raster-enabled shaders without
        # raytracing go to the bg (RASTER_BACKGROUND flag) or fg sets.
        bound = [
            inst for inst in scene.instances
            if inst.desc.mesh is not None and inst.desc.shader is not None
        ]
        active = [
            inst for inst in bound
            if inst.desc.shader.raytrace_enabled
            and not (inst.desc.flags & d.INSTANCE_RASTER_BACKGROUND)
        ]
        raster = [
            inst for inst in bound
            if inst.desc.shader.raster_enabled
            and not inst.desc.shader.raytrace_enabled
            or (inst.desc.flags & d.INSTANCE_RASTER_BACKGROUND)
        ]
        raster_bg = [
            i for i in raster if i.desc.flags & d.INSTANCE_RASTER_BACKGROUND
        ]
        raster_fg = [
            i for i in raster
            if not (i.desc.flags & d.INSTANCE_RASTER_BACKGROUND)
        ]
        everything = active + raster
        self.active_instances = active
        with profiling.span("rt64.pack.quad_pool"):
            self.packer.pack_quad_pool(everything)
            self._sky_rec = self.packer.add_env_texture(view.sky_plane_texture)
            self.packer.set_sky_plane_dense(view.sky_plane_texture)
        with profiling.span("rt64.pack.geometry"):
            self.packer.pack_geometry(active)
        with profiling.span("rt64.pack.frame"):
            self._sb = self.packer.pack_frame(
                everything, scene.lights_array(), raster_bg=raster_bg,
                raster_fg=raster_fg,
            )

    # -- render: the View::render analog ------------------------------------
    def render(self, delta_time_ms: float):
        cfg = self._config()
        n = cfg.rt_height * cfg.rt_width
        if self.history is None or self.history.depth.shape[0] != n:
            self.history = fg.History.zeros(cfg.rt_height, cfg.rt_width,
                                            self.device)
        # The temporal upscaler's history (FSR and XeSS slots): fresh
        # (zeros and resetAccumulation) on the first frame and after any
        # change of shape (rt64_view.cpp:114-141).
        scaling = (cfg.display_height, cfg.display_width) != (
            cfg.rt_height, cfg.rt_width)
        channels = ups.temporal_channels(cfg.upscaler)
        fresh = False
        if scaling and channels:
            shape = (channels, cfg.display_height, cfg.display_width)
            if self._temporal is None or tuple(self._temporal.shape) != shape:
                self._temporal = torch.zeros(shape, device=self.device)
                fresh = True
        else:
            self._temporal = None
        with profiling.span("rt64.view.params"):
            gp = self._global_params(cfg, temporal_reset=fresh)
        out = self._frame(cfg, gp)
        prev = self._last.image if self._last is not None else None
        self._prev_image = (prev if prev is not None
                            and prev.shape == out.image.shape else None)
        if self.pipelined:
            self._last, self._last_cfg = out, cfg
            self._render_pipelined(out, cfg)
            return
        self._pending.clear()  # the ring restarts if pipelining comes back
        # Capacity auto-grow + SAME-FRAME re-render: if this frame dropped
        # alpha hits (compacted-shade overflow), double the capacity boost
        # and render the frame again before presenting. The re-render
        # consumes the dropped frame's output history (one more temporal
        # step), as the JAX package does. The drop scalar and the present
        # are the view's own two host syncs a frame (the frame graph makes
        # its own besides).
        while int(out.alpha_dropped) > 0 and self._alpha_boost < MAX_ALPHA_BOOST:
            self._alpha_boost = min(self._alpha_boost * 2, MAX_ALPHA_BOOST)
            breadcrumb(f"alpha shade capacity overflow; boost -> "
                       f"{self._alpha_boost}; re-rendering frame")
            with profiling.span("rt64.view.rerender"):
                cfg = self._config()
                out = self._frame(cfg, gp)
        self._last, self._last_cfg = out, cfg
        # The RGB8 present: packed on the device, one readback.
        with profiling.stage("rt64.view.present", self.device):
            self._present(fg.present_rgb8(out.image).cpu().numpy(),
                          _pick_planes(out), cfg)

    def _render_pipelined(self, out, cfg):
        """Queue this frame and present the one `pipeline_depth` draws
        older, as the JAX package does (the ring presents nothing until
        it holds depth + 1 frames). The in-flight frame is not read: its
        present and drop scalar are copied to the host behind it."""
        with profiling.stage("rt64.view.present", self.device):
            self._pending.append(self._enqueue(out, cfg))
        if len(self._pending) < self.pipeline_depth + 1:
            return
        done = self._pending.pop(0)
        if done.event is not None:
            done.event.synchronize()
        dropped = int(done.dropped)
        rgb = done.rgb.numpy()
        if dropped > 0 and self._alpha_boost < MAX_ALPHA_BOOST:
            # The frame misses alpha layers and its inputs are gone, so
            # it is not re-rendered: the previous framebuffer stays on
            # screen (and picking on it) for one frame, and the frames
            # queued behind render at the grown capacity.
            self._alpha_boost = min(self._alpha_boost * 2, MAX_ALPHA_BOOST)
            breadcrumb(f"alpha shade capacity overflow; boost -> "
                       f"{self._alpha_boost}; holding previous frame")
        else:
            if dropped > 0:
                breadcrumb(f"alpha shade capacity overflow at boost "
                           f"{self._alpha_boost}: presenting a frame with "
                           f"{dropped} alpha hits dropped")
            self._present(rgb, done.pick, done.cfg)
        if done.event is not None:
            self._spare.append((done.rgb, done.dropped))

    def _enqueue(self, out, cfg) -> _InFlight:
        rgb8 = fg.present_rgb8(out.image)
        if rgb8.device.type != "cuda":
            # The CPU frame is finished when it returns: nothing to copy.
            return _InFlight(rgb8, out.alpha_dropped, None, _pick_planes(out),
                             cfg)
        shape = tuple(rgb8.shape)
        bufs = next((b for b in self._spare if tuple(b[0].shape) == shape), None)
        if bufs is None:
            bufs = (_pinned(shape, torch.uint8), _pinned((), torch.int64))
        else:
            self._spare.remove(bufs)
        # The copies go on the frame's own stream, behind its kernels: no
        # side stream to order against the frame, and the caching
        # allocator may reuse the sources only after the copies on that
        # stream. They are 2.7 MB at 1280x720, 25 MB at 3840x2160.
        bufs[0].copy_(rgb8, non_blocking=True)
        bufs[1].copy_(out.alpha_dropped, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _InFlight(bufs[0], bufs[1], event, _pick_planes(out), cfg)

    def _present(self, rgb, pick, cfg):
        self.view._framebuffer = np.concatenate(
            [rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1
        )
        self._pick_src = (pick, cfg)
        self._pick_plane = None

    def interpolated_midframe(self, t: float = 0.5):
        """Flow-interpolated frame between the two newest renders
        (filters.interpolate_frame) as (DH, DW, 3) uint8, or None until
        two frames of one display size exist. The newest frame's flow is
        in render pixels: resized to the display and scaled by display /
        render size per axis, from the config that frame rendered with
        (the JAX package does neither: ROADMAP queue 3)."""
        if self._last is None or self._prev_image is None:
            return None
        out, cfg = self._last, self._last_cfg
        dh, dw = cfg.display_height, cfg.display_width
        flow = filters.bilinear_resize(fg.to_image(cfg, out.gbuffers.flow),
                                       dh, dw)
        scale = torch.tensor([dw / cfg.rt_width, dh / cfg.rt_height],
                             dtype=torch.float32, device=flow.device)
        img = filters.interpolate_frame(self._prev_image, out.image,
                                        flow * scale[:, None, None], t)
        return fg.present_rgb8(img).cpu().numpy()

    def _frame(self, cfg, gp):
        out = fg.render_frame(self._sb, gp, self.history, self.bn_table, cfg,
                              visualization_mode=self.view.visualization_mode,
                              bg_planes=self._background_planes(cfg),
                              temporal=self._temporal)
        self.history = out.history
        self._temporal = out.temporal
        return out

    def _background_planes(self, cfg):
        """Base plane the in-frame raster-background pass composites onto
        (rt64_view.cpp:1292-1319): black, planar (3, H, W), kept on the
        device per resolution (the frame never writes it)."""
        key = (cfg.rt_height, cfg.rt_width)
        bg = self._bg_cache.get(key)
        if bg is None:
            bg = torch.zeros((3,) + key, device=self.device)
            self._bg_cache[key] = bg
        return bg

    def instance_plane(self):
        """(rt_h, rt_w) int32 instance-id plane of the presented frame,
        fetched on demand and cached until the next present."""
        if self._pick_src is None:
            return None
        if self._pick_plane is None:
            pick, cfg = self._pick_src
            self._pick_plane = (
                fg.to_image(cfg, pick.instance).cpu().numpy().astype(np.int32)
            )
        return self._pick_plane

    @property
    def alpha_boost(self) -> int:
        return self._alpha_boost

    def _config(self) -> fg.RenderConfig:
        view = self.view
        vd = view.desc
        dw, dh = view.width, view.height
        if vd.upscaler != d.UPSCALER_OFF:
            rw, rh = ups.quality_resolution(vd.upscaler_mode, dw, dh,
                                            upscaler=vd.upscaler)
        else:
            rw = max(1, int(dw * vd.resolution_scale))
            rh = max(1, int(dh * vd.resolution_scale))
        # Static pass skips from scene-wide material knowledge: a pass no
        # material can seed is not run at all.
        mats = [i.desc.material for i in view.scene.instances]
        any_refr = any(m.refraction_factor > 1e-6 for m in mats)
        any_refl = any(m.reflection_factor > 1e-6 for m in mats)
        return fg.RenderConfig(
            rt_width=rw,
            rt_height=rh,
            display_width=dw,
            display_height=dh,
            di_samples=int(vd.di_samples),
            gi_samples=int(vd.gi_samples),
            # The reference walks min(sLightCount, maxLightCount) per
            # pixel (Lights.hlsli:137); cap the selection loop by the
            # actual light count.
            max_lights=max(1, min(int(vd.max_lights), len(view.scene.lights))),
            max_reflections=view.max_reflections if any_refl else 0,
            refraction_enabled=any_refr,
            denoiser_enabled=bool(vd.denoiser_enabled),
            motion_blur_enabled=float(vd.motion_blur_strength) > 0.0,
            upscaler=int(vd.upscaler),
            sharpen_enabled=(vd.upscaler != d.UPSCALER_OFF
                             and float(vd.upscaler_sharpness) > 0.0),
            alpha_cap=self.packer.alpha_cap,
            alpha_shade_boost=self._alpha_boost,
        )

    def _global_params(self, cfg, temporal_reset=False) -> fg.GlobalParams:
        view = self.view
        desc = view.scene.desc
        vmat = view.view_matrix.astype(np.float32)
        proj = math3d.perspective_fov_rh(
            view.fov_radians, cfg.display_width / cfg.display_height,
            view.near_dist, view.far_dist,
        )
        view_i = np.linalg.inv(vmat)
        proj_i = np.linalg.inv(proj)
        view_proj = vmat @ proj
        # Reprojection bookkeeping (rt64_view.cpp:977-990).
        if view.can_reproject and self._prev_view_proj is not None:
            prev_view_proj = self._prev_view_proj
            prev_view_i = self._prev_view_i
        else:
            prev_view_proj = view_proj
            prev_view_i = view_i
        self._prev_view_proj = view_proj
        self._prev_view_i = view_i

        cam_u, cam_v, cam_w = math3d.camera_uvw(
            view_i, view.fov_radians, cfg.display_width / cfg.display_height,
            view.near_dist, view.far_dist,
        )
        vd = view.desc
        # Jitter only while an upscaler runs (rt64_view.cpp:1273-1281):
        # this one host value feeds the rays, the fixed-grid background
        # and the sky sample.
        if vd.upscaler != d.UPSCALER_OFF:
            phases = ups.jitter_phase_count(cfg.rt_width, cfg.display_width,
                                            upscaler=cfg.upscaler)
            jitter = math3d.halton_jitter(view.frame_count, phases)
        else:
            jitter = (0.0, 0.0)
        f32 = np.float32
        return global_params_from_numpy(dict(
            view=vmat,
            view_i=view_i.astype(f32),
            prev_view_i=prev_view_i.astype(f32),
            projection=proj,
            projection_i=proj_i.astype(f32),
            view_proj=view_proj.astype(f32),
            prev_view_proj=prev_view_proj.astype(f32),
            camera_u=np.asarray(cam_u, f32),
            camera_v=np.asarray(cam_v, f32),
            camera_w=np.asarray(cam_w, f32),
            pixel_jitter=np.asarray(jitter, f32),
            ambient_base=np.asarray(desc.ambient_base_color, f32),
            ambient_no_gi=np.asarray(desc.ambient_no_gi_color, f32),
            eye_light_diffuse=np.asarray(desc.eye_light_diffuse_color, f32),
            eye_light_specular=np.asarray(desc.eye_light_specular_color, f32),
            sky_diffuse_mult=np.asarray(desc.sky_diffuse_multiplier, f32),
            sky_hsl_mod=np.asarray(desc.sky_hsl_modifier, f32),
            sky_yaw_offset=np.float32(desc.sky_yaw_offset),
            gi_diffuse_strength=np.float32(desc.gi_diffuse_strength),
            gi_sky_strength=np.float32(desc.gi_sky_strength),
            motion_blur_strength=np.float32(vd.motion_blur_strength),
            sky_plane_rec=np.int32(self._sky_rec),
            frame_count=np.uint32(view.frame_count),
            di_reproject=np.bool_(False),  # DI_REPROJECTION_SUPPORT undefined
            gi_reproject=np.bool_(bool(vd.denoiser_enabled) and vd.gi_samples > 0),
            binary_lock_mask=np.bool_(vd.upscaler != d.UPSCALER_FSR),
            temporal_reset=np.bool_(temporal_reset),
            upscaler_sharpness=np.float32(vd.upscaler_sharpness),
        ), self.device)


def _pick_planes(out) -> PickPlanes:
    return PickPlanes(out.gbuffers.instance, out.gbuffers.position)
