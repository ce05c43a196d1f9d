"""N64 sky plane sampling (BgSky.hlsli) — planar.

The sky plane is the N64 skybox recreated from the decompilation's
320x240-based math (BgSky.hlsli:8-11). On the regular primary-ray grid
its texture coordinate is affine in screen position, so the frame
samples it as a separable wrap-bilinear resample of the dense sky
texture (SceneBuffers.sky_plane). Bounce rays that miss the scene look
it up by direction through the quad pool (sample_sky_plane).

The raster background plane (SampleBackground2D, BgSky.hlsli:86-96) is
read on the same grid as a uniform jitter shift of the plane
(sample_background_grid), and by direction, as an environment map, by
bounce rays that miss (sample_background_env).
"""

from __future__ import annotations

import numpy as np
import torch

from rt64tpu_torch.ops import filters
from rt64tpu_torch.ops import texture as tex_ops
from rt64tpu_torch.ops.colorspace import mod_rgb_with_hsl

M_PI = 3.14159265
M_TWO_PI = M_PI * 2.0
SCREEN_WIDTH = 320
SCREEN_HEIGHT = 240
SKYBOX_WIDTH = 4 * SCREEN_WIDTH
SKYBOX_HEIGHT = 4 * SCREEN_HEIGHT


def fake_env_map_uv(ray_dir, yaw_offset):
    """FakeEnvMapUV (BgSky.hlsli:14-18). ray_dir: (3, N) -> (u, v)."""
    yaw = torch.remainder(
        yaw_offset + torch.atan2(ray_dir[0], -ray_dir[2]) + M_PI, M_TWO_PI
    )
    pitch = torch.remainder(
        torch.atan2(-ray_dir[1],
                    torch.sqrt(ray_dir[0] ** 2 + ray_dir[2] ** 2)) + M_PI,
        M_TWO_PI,
    )
    return yaw / M_TWO_PI, pitch / M_TWO_PI


def _sample_env_scalar_rec(pool, records, sky_rec, u, v):
    """Bilinear wrap/wrap sample of ONE texture record for every lane:
    sky_rec may be () or (N,), only lane 0 is used; a negative id gives
    transparent black."""
    rec = sky_rec.reshape(-1)[0].to(torch.int64)
    row = records[torch.clamp(rec, min=0)]
    n = u.shape
    dev = u.device
    wrap = torch.full(n, tex_ops.ADDR_WRAP, dtype=torch.int32, device=dev)
    return tex_ops.sample_quad_cols(
        pool, row[0], row[1], row[2], rec >= 0, u, v,
        torch.ones(n, dtype=torch.bool, device=dev), wrap, wrap,
    )


def sample_sky_plane(pool, records, sky_rec, ray_dir, yaw_offset,
                     sky_diffuse_multiplier, sky_hsl_modifier):
    """SampleSkyPlane (BgSky.hlsli:72-84): the sky by ray direction,
    (4, N)."""
    u, v = fake_env_map_uv(ray_dir, yaw_offset)
    color = _sample_env_scalar_rec(pool, records, sky_rec, u, v)
    return _finish_sky(color, sky_diffuse_multiplier, sky_hsl_modifier)


def _sky_base(view_i, viewport_wh, yaw_offset):
    """ComputeSkyPlaneUV's per-frame terms (BgSky.hlsli:20-52):
    (base_x, base_y, ratio_division) as 0-d tensors."""
    view_dir = view_i[2, :3]
    view_dir = view_dir / torch.sqrt((view_dir * view_dir).sum())
    sky_yaw = torch.remainder(
        yaw_offset + torch.atan2(view_dir[0], -view_dir[2]) + M_PI, M_TWO_PI
    )
    base_x = SCREEN_WIDTH * 360.0 * (sky_yaw - M_PI) / (90.0 * M_PI * 2.0)
    sky_pitch = torch.atan2(
        -view_dir[1], torch.sqrt(view_dir[0] ** 2 + view_dir[2] ** 2)
    )
    pitch_deg = sky_pitch * 360.0 / (M_PI * 2.0)
    base_y = 360.0 * pitch_deg / 90.0 + 5.0 * (SCREEN_HEIGHT / 2.0)
    base_y = torch.clamp(base_y, SCREEN_HEIGHT, SKYBOX_HEIGHT)
    aspect = viewport_wh[0] / viewport_wh[1]
    base_x = base_x + SCREEN_WIDTH / 2.0 - (SCREEN_HEIGHT * aspect) / 2.0
    base_x = base_x / SKYBOX_WIDTH
    base_y = (SKYBOX_HEIGHT - base_y) / SKYBOX_HEIGHT
    ratio_division = aspect / (4.0 / 3.0)
    return base_x, base_y, ratio_division


def _finish_sky(color, sky_diffuse_multiplier, sky_hsl_modifier):
    """color: (4, N). Applies the multiplier and, when any HSL modifier
    component is non-zero, the HSL mod."""
    rgb = color[:3] * sky_diffuse_multiplier.reshape(3, 1)
    moded = mod_rgb_with_hsl(rgb.T, sky_hsl_modifier).T
    rgb = torch.where(torch.any(sky_hsl_modifier != 0.0), moded, rgb)
    return torch.cat([rgb, color[3:4]], dim=0)


def _wrap_band(n_out: int, n_in: int, off, step):
    """(n_out, n_in) bilinear weight matrix for the uniform coordinate
    grid x_i = off + i*step (continuous texel coords, 0-d tensors)
    under WRAP addressing — the quad pool's wrap remap + floor/frac with
    the baked mod-(n_in) +1 neighbor."""
    dev = off.device
    x = off + step * torch.arange(n_out, dtype=torch.float32, device=dev)
    x = torch.remainder(x, float(n_in))
    x0f = torch.floor(x)
    f = x - x0f
    x0 = torch.clamp(x0f.to(torch.int64), 0, n_in - 1)
    x1 = torch.remainder(x0 + 1, n_in)
    j = torch.arange(n_in, device=dev)[None, :]
    return (
        (j == x0[:, None]) * (1.0 - f)[:, None]
        + (j == x1[:, None]) * f[:, None]
    ).to(torch.float32)


def sample_sky_2d_grid(
    sky_plane, sky_rec, jitter, view_i, viewport_wh, yaw_offset,
    sky_diffuse_multiplier, sky_hsl_modifier,
    w: int, h: int, grid_height: int, row_offset: int = 0,
):
    """SampleSky2D (BgSky.hlsli:54-70) on the REGULAR pixel grid as a
    separable resample: u = base_x + su*0.25*ratio, v = base_y + sv*0.25
    is affine in screen uv, so the per-pixel sample is two banded
    wrap-bilinear products. sky_plane: (4, Ht, Wt) f32 dense texture;
    su = (px+jx)/w, sv = (py+jy)/grid_height. Returns (4, h*w)."""
    c, ht, wt = sky_plane.shape
    base_x, base_y, ratio_division = _sky_base(view_i, viewport_wh, yaw_offset)

    # u = base_x + (px + jx)/w * 0.25*rd  ->  texel x = u*Wt - 0.5
    step_x = 0.25 * ratio_division / w * wt
    off_x = (base_x + jitter[0] / w * 0.25 * ratio_division) * wt - 0.5
    step_y = torch.tensor(0.25 / grid_height * ht, device=sky_plane.device)
    off_y = (
        base_y + (jitter[1] + row_offset) / grid_height * 0.25
    ) * ht - 0.5
    cm = _wrap_band(w, wt, off_x, step_x)  # (w, Wt)
    rm = _wrap_band(h, ht, off_y, step_y)  # (h, Ht)
    t = torch.einsum("oh,chw->cow", rm, sky_plane)
    img = torch.einsum("cow,pw->cop", t, cm)
    color = img.reshape(c, h * w)
    # Runtime no-sky gate (rec < 0 -> transparent).
    color = color * (sky_rec >= 0)
    return _finish_sky(color, sky_diffuse_multiplier, sky_hsl_modifier)


def sample_background_grid(bg_planes, jx: float, jy: float):
    """SampleBackground2D on the regular pixel grid: a uniform
    (jx-0.5, jy-0.5) texel shift of the plane itself, done as an
    edge-padded window + 4-tap scalar-weight blend (no gather). The
    jitter is known on the host, so the window's offset is too. Matches
    bilinear_quad's clip/floor math: both taps collapse onto the edge
    texel outside the image. bg_planes: (3, H, W); returns (3, H*W)."""
    c, h, w = bg_planes.shape
    f = np.float32
    dx = f(jx) - f(0.5)
    dy = f(jy) - f(0.5)
    x0 = min(max(np.floor(dx), f(-1.0)), f(0.0))
    y0 = min(max(np.floor(dy), f(-1.0)), f(0.0))
    fx = float(dx - x0)
    fy = float(dy - y0)
    pad = torch.nn.functional.pad(bg_planes[None], (1, 1, 1, 1),
                                  mode="replicate")[0]
    oy, ox = 1 + int(y0), 1 + int(x0)
    win = pad[:, oy : oy + h + 1, ox : ox + w + 1]
    out = (
        win[:, :h, :w] * float(f(1 - fx) * f(1 - fy))
        + win[:, :h, 1:] * float(f(fx) * f(1 - fy))
        + win[:, 1:, :w] * float(f(1 - fx) * f(fy))
        + win[:, 1:, 1:] * float(f(fx) * f(fy))
    )
    return out.reshape(c, h * w)


def sample_background_2d(bg_planes, su, sv):
    """SampleBackground2D: bilinear sample of the raster background.
    bg_planes: (3, H, W) planar image; su/sv: (N,). Returns (3, N)."""
    packed = filters.quad_pack_planar(bg_planes)
    return filters.bilinear_quad(
        packed, 3, bg_planes.shape[1], bg_planes.shape[2], su, sv
    )


def sample_background_env(bg_planes, ray_dir):
    """SampleBackgroundAsEnvMap (BgSky.hlsli:94-96)."""
    u, v = fake_env_map_uv(ray_dir, 0.0)
    return sample_background_2d(bg_planes, u, v)
