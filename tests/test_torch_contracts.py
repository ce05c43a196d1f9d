"""Contracts shared by rt64tpu and rt64tpu_torch: layouts, constants,
Morton order, combiner decode/eval, the TEA hash and the blue-noise
table. Inputs come from numpy with fixed seeds and go through both
packages."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rt64tpu import descriptors as jd
from rt64tpu import limits as jl
from rt64tpu.ops import bluenoise as jbn
from rt64tpu.ops import combiner as jcomb
from rt64tpu.ops import geometry as jgeo
from rt64tpu.ops import random as jrnd
from rt64tpu.pipeline import rows as jrows

from rt64tpu_torch import descriptors as pd
from rt64tpu_torch import limits as pl
from rt64tpu_torch.ops import bluenoise as pbn
from rt64tpu_torch.ops import combiner as pcomb
from rt64tpu_torch.ops import geometry as pgeo
from rt64tpu_torch.ops import random as prnd
from rt64tpu_torch.pipeline import rows as prows


def _constants(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (int, float, tuple))}


def _rows_in_port_form(consts):
    """The JAX package's row constants with its eligibility columns, one
    per light slot (MAX_ELIG_LIGHTS of them), replaced by the port's two
    light group mask columns at the same offset (*_ELIG -> *_LMASK): every
    instance, triangle and context offset past them moves down by the
    difference."""
    slots = consts.pop("MAX_ELIG_LIGHTS")
    shift = slots - 2
    out = {}
    for name, value in consts.items():
        if name.endswith("_ELIG"):
            out[name.replace("_ELIG", "_LMASK")] = value
            continue
        for prefix, row, start in (("I_", "IROW", "I_ELIG"),
                                   ("T_", "TROW", "T_ELIG"),
                                   ("CTX", "CTXROW", "CTX_ELIG")):
            if (name.startswith(prefix) or name == row) and isinstance(
                    value, int) and value > consts[start]:
                value -= shift
        out[name] = value
    out["CTX_RUNS"] = consts["CTX_RUNS"][:-1] + ((consts["T_ELIG"], 2),)
    return out


@pytest.mark.parametrize("pair", ["rows", "descriptors"])
def test_constants_equal(pair):
    """Equal constants; the row layouts differ only in the light columns
    (pipeline/rows.py), mapped exactly by _rows_in_port_form."""
    jmod, pmod = {"rows": (jrows, prows), "descriptors": (jd, pd)}[pair]
    want = _constants(jmod)
    got = _constants(pmod)
    if pair == "rows":
        want = _rows_in_port_form(want)
        assert got.pop("LMASK_HALF") == 1 << 16
    assert want == got
    assert len(_constants(pmod)) > 20


def test_descriptor_and_limit_defaults_equal():
    for name in ("Material", "Light", "SceneDesc", "ViewDesc", "TextureDesc"):
        j = dataclasses.asdict(getattr(jd, name)())
        p = dataclasses.asdict(getattr(pd, name)())
        assert j == p, name
    assert dataclasses.asdict(jl.SceneLimits()) == dataclasses.asdict(pl.SceneLimits())
    grow = dict(vertices=70000, triangles=20000, instances=130, lights=5,
                textures=3, texels=1 << 21)
    assert (dataclasses.asdict(jl.SceneLimits().grown_for(**grow))
            == dataclasses.asdict(pl.SceneLimits().grown_for(**grow)))
    assert jrows.pack_cc((1, 2, 3, 4), (5, 6, 7, 0)) == prows.pack_cc(
        (1, 2, 3, 4), (5, 6, 7, 0))


def test_morton_order_equal():
    rng = np.random.default_rng(0)
    verts = rng.uniform(-50, 50, (600, 3)).astype(np.float32)
    idx = rng.integers(0, 600, (900, 3))
    np.testing.assert_array_equal(
        jgeo.morton_order(verts, idx), pgeo.morton_order(verts, idx)
    )


def _combiner_sweep():
    """The shader-id sweep of tests/test_combiner.py (seed 0)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2000):
        sid = int(rng.integers(0, 1 << 24)) | (int(rng.integers(0, 2)) << 24)
        out.append((sid, rng.random((4, 4)).astype(np.float32),
                    rng.random(4).astype(np.float32),
                    rng.random(4).astype(np.float32)))
    return out


def test_decode_combiner_agrees_over_sweep():
    for sid, _, _, _ in _combiner_sweep():
        assert (dataclasses.asdict(jcomb.decode_combiner(sid))
                == dataclasses.asdict(pcomb.decode_combiner(sid))), hex(sid)


def test_combiner_eval_planar_agrees():
    sweep = _combiner_sweep()
    params = np.stack([jcomb.decode_combiner(s).packed() for s, _, _, _ in sweep])
    inputs = np.stack([x[1] for x in sweep])  # (N, 4 inputs, 4 rgba)
    tex0 = np.stack([x[2] for x in sweep]).T
    tex1 = np.stack([x[3] for x in sweep]).T
    items = np.concatenate([params[:, 0:4], params[:, 4:8]], axis=1).T
    planes = [inputs[:, i].T for i in range(4)]
    want = np.asarray(jcomb.combiner_eval_planar(
        jnp.asarray(items), jnp.asarray(params[:, 8] != 0),
        jnp.asarray(params[:, 11] != 0), *map(jnp.asarray, planes),
        jnp.asarray(tex0), jnp.asarray(tex1),
    ))
    got = pcomb.combiner_eval_planar(
        torch.from_numpy(items), torch.from_numpy(params[:, 8] != 0),
        torch.from_numpy(params[:, 11] != 0), *map(torch.from_numpy, planes),
        torch.from_numpy(tex0), torch.from_numpy(tex1),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_tea_hash_and_lcg_bit_equal():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    b[:4] = [0xFFFFFFFF, 0, 0x9E3779B9, 0]
    j_seed = jrnd.init_rand(jnp.asarray(a), jnp.asarray(b))
    p_seed = prnd.init_rand(torch.from_numpy(a.astype(np.int64)),
                            torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(
        np.asarray(j_seed).astype(np.int64), p_seed.numpy())
    j_next, j_val = jrnd.next_rand(j_seed)
    p_next, p_val = prnd.next_rand(p_seed)
    np.testing.assert_array_equal(
        np.asarray(j_next).astype(np.int64), p_next.numpy())
    np.testing.assert_array_equal(np.asarray(j_val), p_val.numpy())


def test_bluenoise_u8_table_equals_jax_table():
    u8 = pbn.table_u8()
    assert u8.dtype == np.uint8 and u8.shape == (64, 64, 64, 3)
    np.testing.assert_array_equal(u8 / np.float32(255.0), jbn.get_table())
    np.testing.assert_array_equal(
        pbn.packed_table(), jbn.packed_table().astype(np.int64))
