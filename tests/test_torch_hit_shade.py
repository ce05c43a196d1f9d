"""The hit shader's kernel (csrc/hit_shade.cu, tracer_cuda.hit_shade)
against its plain version (shading.shade_hits_plain), and the wrapper's
choice and checks.

On the CPU: shade_hits sends CPU tensors to the plain version (the JAX
parity tests of tests/test_torch_shading.py hold that one), the wrapper
raises on a dtype, shape or device the kernel does not take, and the
kernel's constants are the row layout's.

On the card (marked `cuda`, skipped elsewhere with a reason; this file
imports neither JAX nor the JAX package):

    python -m pytest tests/test_torch_hit_shade.py --noconftest -q

the kernel against the plain version run on the same card, on seeded
lanes over random triangle rows: every operand id 0-7 in each of the 8
combiner items, opt_alpha, color_alpha_same, texture edge and noise on
and off, the shadow variant, each of the scene's features on and off,
point and bilinear filtering under each address mode, miss lanes
(tri = -1), zero-size records (NaN texel coordinates), both pool
layouts, strided int64 and contiguous int32 lanes, and a width that is
no multiple of the block. Integer planes are equal and float planes
equal bit for bit (NaN where both are NaN): 0 ulps. The one place where
ATen does not fix the order of the plain version's arithmetic is the
sum over three components in vecmath.dot (a reduction): the kernel adds
them in the order ATen's CUDA reduction takes for the plane's layout,
(p0 + p1) + p2 for a (3, M) plane, (p0 + p2) + p1 for a lane-major one
(the gathered rows' differences; strided directions and differentials,
the "strided" layout here). Another order moves such a sum by an ulp,
the normal's components by a few (13 and 68 ulps were read with the
lane-major order left out) and the mip level's inputs likewise.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

from rt64tpu_torch.ops import shading
from rt64tpu_torch.ops import texture as tex
from rt64tpu_torch.ops import tracer_cuda as tc
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.pipeline.scene_buffers import ShadeFeatures

CSRC = os.path.join(os.path.dirname(tc.__file__), os.pardir, "csrc")
TRIS = 512
QUADS = 64 * tex.QPR
LANES = 1000  # no multiple of the kernel's 128-lane block


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(rng):
    """Random triangle rows: a sixth with zero vertex normals (the face
    normal's fallback), UV corners of the tangent's four cases, random
    combiners, flags, samplers and texture records (some zero-size)."""
    rows = np.zeros((TRIS, R.TROW), np.float32)
    corners = rng.uniform(-10, 10, (TRIS, 9))
    rows[:, R.T_P0:R.T_N0] = corners
    normals = rng.normal(size=(TRIS, 9))
    normals[rng.uniform(size=TRIS) < 0.15] = 0.0
    rows[:, R.T_N0:R.T_UV] = normals
    uv = rng.uniform(-2, 3, (TRIS, 3, 2))
    kind = rng.integers(0, 4, TRIS)
    uv[kind == 1, 1:] = uv[kind == 1, :1]  # uvk, uva, uvb all 0
    uv[kind == 2, 2] = 2 * uv[kind == 2, 1] - uv[kind == 2, 0]  # collinear
    uv[kind == 3, 1] = uv[kind == 3, 0]  # uva = uvc = 0, uvb != 0
    rows[:, R.T_UV:R.T_IN1] = uv.reshape(TRIS, 6)
    rows[:, R.T_IN1:R.T_PP0] = rng.uniform(0, 1, (TRIS, 24))
    rows[:, R.T_PP0:R.T_INST] = corners + rng.normal(0, 0.1, (TRIS, 9))
    rows[:, R.T_INST] = rng.integers(0, 100, TRIS)
    mat = rng.uniform(0, 1.5, (TRIS, R.M_WIDTH))
    mat[:, R.M_DIFFUSE_MIX + 3] = rng.uniform(-1, 1, TRIS)
    mat[:, R.M_UV_DETAIL] = rng.uniform(0.5, 4, TRIS)
    rows[:, R.T_MAT:R.T_CC] = mat
    items = rng.integers(0, 8, (TRIS, 8))
    rows[:, R.T_CC] = [R.pack_cc(i[:4], i[4:]) for i in items]
    rows[:, R.T_FLAGS] = rng.integers(0, 1 << 12, TRIS)
    for col in (R.T_TEX_D, R.T_TEX_N, R.T_TEX_S, R.T_TEX_D2):
        rows[:, col] = rng.integers(-1, 4, TRIS)
    rows[:, R.T_SAMPLER] = (rng.integers(0, 2, TRIS) + 4 * rng.integers(0, 4, TRIS)
                            + 16 * rng.integers(0, 4, TRIS))
    rows[:, R.T_LMASK:R.T_INPUT_COUNT] = rng.integers(0, R.LMASK_HALF,
                                                      (TRIS, 2))
    rec = np.stack([rng.integers(0, QUADS, (TRIS, 4)),
                    rng.integers(0, 17, (TRIS, 4)),
                    rng.integers(0, 17, (TRIS, 4))], -1)
    rows[:, R.T_REC:R.TROW] = rec.reshape(TRIS, 12)
    return rows, items


def hit_inputs(seed, device, features=(True,) * 4, layout="wide"):
    """(sb, args, kw, items of each lane) for one shade_hits call.
    features: (has_texel1, has_normal_maps, has_specular_maps, has_mips);
    mip_args are passed either way (the plain version reads them only
    with has_mips). layout: "wide" (wide pool, contiguous int32 lanes),
    "narrow" ((P, 4) pool) or "strided" (int64 ids, every lane input a
    strided view, as an alpha slot's column)."""
    rng = np.random.default_rng(seed)
    rows, items = _rows(rng)
    words = rng.integers(0, 2**32, (QUADS, 4), dtype=np.int64)
    pool = words if layout == "narrow" else tex.pack_pool_wide(words)
    t1, nmap, smap, mips = features
    sb = types.SimpleNamespace(
        quad_pool=torch.from_numpy(pool).to(device),
        features=ShadeFeatures(has_texel1=t1, has_normal_maps=nmap,
                               has_specular_maps=smap, has_mips=mips))
    m = LANES
    tri = rng.integers(0, TRIS, m)
    tri[rng.uniform(size=m) < 0.15] = -1
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    bary = rng.uniform(0, 1, (m, 2))
    dirs = rng.normal(size=(3, m))
    noise = rng.uniform(0, 1, m)
    if layout == "strided":
        ids = np.full((m, 3), -1, np.int64)
        ids[:, 1] = tri
        slots = np.zeros((m, 3, 2))
        slots[:, 1] = bary
        tri_t = torch.from_numpy(ids).to(device)[:, 1]
        slots_t = f32(slots)
        u, v = slots_t[:, 1, 0], slots_t[:, 1, 1]
        dir_t = f32(np.ascontiguousarray(dirs.T)).T
        noise_t = f32(np.stack([noise, noise]))[1]
    else:
        tri_t = torch.from_numpy(tri.astype(np.int32)).to(device)
        u, v = f32(bary[:, 0]), f32(bary[:, 1])
        dir_t, noise_t = f32(dirs), f32(noise)
    ddx, ddy = rng.normal(0, 1e-3, (2, 3, m))
    if layout == "strided":  # lane-major differentials, one dense, one not
        ddx_t = f32(np.ascontiguousarray(ddx.T)).T
        ddy_t = f32(np.ascontiguousarray(np.concatenate([ddy.T, ddy.T], 1)))[:, :3].T
    else:
        ddx_t, ddy_t = f32(ddx), f32(ddy)
    mip_args = (f32(rng.uniform(0.1, 50, m)), ddx_t, ddy_t)
    args = (sb, f32(rows), dir_t, tri_t, u, v, noise_t)
    return sb, args, dict(mip_args=mip_args), items[np.maximum(tri, 0)][tri >= 0]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version(monkeypatch):
    _, args, kw, _ = hit_inputs(0, "cpu")
    want = shading.shade_hits_plain(*args, **kw)
    calls = []
    plain = shading.shade_hits_plain
    monkeypatch.setattr(shading, "shade_hits_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    monkeypatch.setattr(tc, "hit_shade", None)  # never reached
    got = shading.shade_hits(*args, **kw)
    assert calls == [1]
    for name, g, w in zip(shading.HitShade._fields, got, want):
        assert torch.equal(g, w) or _bits_equal(g, w), name


def _mutated(case):
    """A CPU call with one input the kernel does not take."""
    sb, args, kw, _ = hit_inputs(1, "cpu")
    sb_, rows, dirs, tri, u, v, noise = args
    t_hit, ddx, ddy = kw["mip_args"]
    m = tri.shape[0]
    if case == "tri_float":
        tri = tri.float()
    elif case == "tri_2d":
        tri = tri[None]
    elif case == "u_float64":
        u = u.double()
    elif case == "dir_rows":
        dirs = torch.zeros((4, m))
    elif case == "noise_length":
        noise = torch.zeros(m + 1)
    elif case == "rows_width":
        rows = rows[:, :-1].contiguous()
    elif case == "rows_strided":
        rows = torch.zeros((rows.shape[0], 2 * R.TROW))[:, ::2]
    elif case == "pool_int32":
        sb = types.SimpleNamespace(quad_pool=sb.quad_pool.int(),
                                   features=sb.features)
    elif case == "pool_width":
        sb = types.SimpleNamespace(quad_pool=torch.zeros((8, 3), dtype=torch.int64),
                                   features=sb.features)
    elif case == "mip_t_length":
        t_hit = torch.zeros(m + 1)
    elif case == "mip_ddx_float64":
        ddx = ddx.double()
    return (sb, rows, dirs, tri, u, v, noise), dict(mip_args=(t_hit, ddx, ddy))


@pytest.mark.parametrize("case", [
    "tri_float", "tri_2d", "u_float64", "dir_rows", "noise_length",
    "rows_width", "rows_strided", "pool_int32", "pool_width", "mip_t_length",
    "mip_ddx_float64"])
def test_wrapper_raises_on_inputs_the_kernel_does_not_take(case):
    args, kw = _mutated(case)
    with pytest.raises(ValueError, match="must be"):
        tc.hit_shade(*args, **kw)


def test_wrapper_launches_on_a_cuda_device_only():
    _, args, kw, _ = hit_inputs(2, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tc.hit_shade(*args, **kw)


def _constants(name):
    with open(os.path.join(CSRC, name)) as f:
        text = f.read()
    return {k: eval(v, {}) for k, v in
            re.findall(r"constexpr int (\w+) = ([^;]+);", text)}


def test_constants_match_the_row_layout():
    got = _constants("hit_shade.cu")
    layout = [k for k in got if k == "TROW" or k[:2] in ("T_", "M_", "F_")]
    assert {k: got[k] for k in layout} == {k: getattr(R, k) for k in layout}
    assert (got["QPR"], got["MAX_MIP_LEVELS"]) == (tex.QPR, tex.MAX_MIP_LEVELS)
    bits = ("SHADOW", "TEXEL1", "NORMAL_MAPS", "SPECULAR_MAPS", "MIPS",
            "DIR_LANE_MAJOR", "DDX_LANE_MAJOR", "DDY_LANE_MAJOR")
    assert [got[f"V_{b}"] for b in bits] == [getattr(tc, f"HIT_{b}") for b in bits]


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _ulps(g, w):
    """Largest distance in units in the last place (NaN against NaN 0;
    NaN against a number: infinite); -0.0 and +0.0 count as one."""
    nan_g, nan_w = torch.isnan(g), torch.isnan(w)
    if not torch.equal(nan_g, nan_w):
        return float("inf")
    order = lambda x: torch.where(x.view(torch.int32) < 0,
                                  -(x.view(torch.int32) & 0x7FFFFFFF),
                                  x.view(torch.int32)).long()
    d = (order(g) - order(w)).abs()[~nan_g]
    return int(d.max()) if d.numel() else 0


def _bits_equal(g, w):
    same = g.view(torch.int32) == w.view(torch.int32)
    return bool((same | (torch.isnan(g) & torch.isnan(w))).all())


def assert_matches_plain(got, want):
    for name, g, w in zip(shading.HitShade._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype != torch.float32:
            assert torch.equal(g, w), name
        else:
            assert _bits_equal(g, w), (name, "ulps", _ulps(g, w))


FEATURES = [(t1, nmap, smap, mips) for t1 in (False, True)
            for nmap in (False, True) for smap in (False, True)
            for mips in (False, True)]
fid = lambda f: "-".join(n for n, on in zip(("t1", "nmap", "smap", "mips"), f) if on) or "none"


@pytest.mark.cuda
@pytest.mark.parametrize("features", FEATURES, ids=[fid(f) for f in FEATURES])
def test_lit_kernel_matches_plain(card, features):
    _, args, kw, items = hit_inputs(3, card, features)
    # Every operand id in each of the 8 combiner items.
    assert all(set(items[:, k]) == set(range(8)) for k in range(8))
    before = tc.launch_counts.hit_shade_launches
    got = shading.shade_hits(*args, **kw)
    assert tc.launch_counts.hit_shade_launches == before + 1
    assert_matches_plain(got, shading.shade_hits_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("texel1", [False, True], ids=["none", "t1"])
def test_shadow_kernel_matches_plain(card, texel1):
    _, args, kw, _ = hit_inputs(4, card, (texel1, True, True, True))
    got = shading.shade_hits(*args, shadow_variant=True, **kw)
    assert_matches_plain(
        got, shading.shade_hits_plain(*args, shadow_variant=True, **kw))
    assert got.normal is got.specular is got.flow
    assert not got.normal.any()


@pytest.mark.cuda
@pytest.mark.parametrize("shadow", [False, True], ids=["lit", "shadow"])
@pytest.mark.parametrize("layout", ["narrow", "strided"])
def test_kernel_matches_plain_on_other_layouts(card, layout, shadow):
    _, args, kw, _ = hit_inputs(5, card, layout=layout)
    got = shading.shade_hits(*args, shadow_variant=shadow, **kw)
    assert_matches_plain(
        got, shading.shade_hits_plain(*args, shadow_variant=shadow, **kw))


@pytest.mark.cuda
def test_one_launch_a_call_and_none_for_no_lanes(card):
    _, args, kw, _ = hit_inputs(6, card)
    before = tc.launch_counts.hit_shade_launches
    shading.shade_hits(*args, **kw)
    shading.shade_hits(*args, shadow_variant=True, **kw)
    assert tc.launch_counts.hit_shade_launches == before + 2
    sb, rows, dirs, tri, u, v, noise = args
    empty = shading.shade_hits(sb, rows, dirs[:, :0], tri[:0], u[:0], v[:0],
                               noise[:0])
    assert tc.launch_counts.hit_shade_launches == before + 2
    assert empty.color.shape == (4, 0) and empty.rows_t.shape == (R.TROW, 0)
