"""ViewRenderer: drives the frame graph for an api.View.

The View::update / View::render split of the reference
(rt64_view.cpp:1053-1178 / :1180-1667): update() assembles scene
buffers (instance classification + uploads), render() runs the frame
and retains the outputs for presentation and picking, and carries the
temporal upscaler's display-size history from frame to frame. Frames
are full sync, like the reference (rt64_device.cpp:1006-1025): the
present reads the RGB8 frame back, and the alpha-overflow check reads
one device scalar per frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rt64tpu_torch import descriptors as d
from rt64tpu_torch.convert import global_params_from_numpy
from rt64tpu_torch.models import upscaler as ups
from rt64tpu_torch.ops import bluenoise, math3d
from rt64tpu_torch.pipeline import framegraph as fg
from rt64tpu_torch.pipeline.scene_buffers import ScenePacker
from rt64tpu_torch.utils.log import breadcrumb

MAX_ALPHA_BOOST = 16


class ViewRenderer:
    def __init__(self, view, pipelined: bool = False):
        if pipelined:
            raise NotImplementedError(
                "the pipelined present ring is not ported yet: ROADMAP "
                "queue 1 item 13"
            )
        self.view = view
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
        self._last = None
        self._alpha_boost = 1
        self._pick_src = None  # (FrameOutputs, cfg) of the presented frame
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
        self.packer.pack_quad_pool(everything)
        self._sky_rec = self.packer.add_env_texture(view.sky_plane_texture)
        self.packer.set_sky_plane_dense(view.sky_plane_texture)
        self.packer.pack_geometry(active)
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
        gp = self._global_params(cfg, temporal_reset=fresh)
        out = self._frame(cfg, gp)
        # Capacity auto-grow + SAME-FRAME re-render: if this frame dropped
        # alpha hits (compacted-shade overflow), double the capacity boost
        # and render the frame again before presenting. The re-render
        # consumes the dropped frame's output history (one more temporal
        # step), as the JAX package does. The drop scalar is the frame's
        # one host sync apart from the present.
        while int(out.alpha_dropped) > 0 and self._alpha_boost < MAX_ALPHA_BOOST:
            self._alpha_boost = min(self._alpha_boost * 2, MAX_ALPHA_BOOST)
            breadcrumb(f"alpha shade capacity overflow; boost -> "
                       f"{self._alpha_boost}; re-rendering frame")
            cfg = self._config()
            out = self._frame(cfg, gp)
        self._last = out
        # The RGB8 present: packed on the device, one readback.
        frame = fg.present_rgb8(out.image).cpu().numpy()
        self.view._framebuffer = np.concatenate(
            [frame, np.full(frame.shape[:2] + (1,), 255, np.uint8)], axis=-1
        )
        self._pick_src = (out, cfg)
        self._pick_plane = None

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
            out, cfg = self._pick_src
            self._pick_plane = (
                fg.to_image(cfg, out.gbuffers.instance).cpu().numpy()
                .astype(np.int32)
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

