"""Scene packing: every SceneBuffers field and ShadeFeatures flag the
port's ScenePacker emits equals the JAX package's, exactly, on the
sample and castle scenes (the port's host copies of the raster tables,
raster_host, equal the JAX fields they copy); so do the per-frame
GlobalParams of the two view drivers. The instance rows' light columns
differ in form (the port's light group mask, the JAX package's
eligibility per light slot): the port's rows mapped into the JAX form
with the lights' group bits (convert.rows_to_slots) equal the JAX rows
exactly."""

import numpy as np
import pytest

from rt64tpu.utils.castle_scene import build_castle_scene as jax_castle
from rt64tpu.utils.testscenes import build_sample_scene as jax_sample

from rt64tpu_torch.convert import rows_to_slots
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.pipeline.scene_buffers import SceneBuffers
from rt64tpu_torch.utils.castle_scene import build_castle_scene as port_castle
from rt64tpu_torch.utils.testscenes import build_sample_scene as port_sample

SCENES = {
    "castle": (jax_castle, port_castle, dict(foliage=12)),
    "sample": (jax_sample, port_sample, {}),
}


def _renderers(name):
    jax_build, port_build, extra = SCENES[name]
    _, _, jview = jax_build(width=128, height=64, gi_samples=0, **extra)
    _, _, pview = port_build(width=128, height=64, gi_samples=0,
                             device="cpu", **extra)
    for v in (jview, pview):
        v.max_reflections = 0
        v.update()
    return jview._renderer, pview._renderer


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_buffers_equal(name):
    jr, pr = _renderers(name)
    jsb, psb = jr._sb, pr._sb
    assert psb.features._asdict() == jsb.features._asdict()
    count = int(psb.light_count)
    groups = psb.light_groups.numpy()
    assert count == len(pr.view.scene.lights)
    assert (groups[count:] == 0).all()
    assert groups[:count].tolist() == [
        int(light.group_bits) - (1 << 32) * (int(light.group_bits) >= 1 << 31)
        for light in pr.view.scene.lights]
    slots = lambda rows: rows_to_slots(rows, R.I_LMASK, groups, count)
    for field in SceneBuffers._fields:
        if field in ("features", "light_groups"):
            continue
        if field == "raster_host":
            # The port's host copies of the raster tables: the JAX
            # package's rows up to each count, instance rows and records.
            host = psb.raster_host
            for layer in ("bg", "fg"):
                n = int(np.asarray(getattr(jsb, f"raster_{layer}_count")))
                np.testing.assert_array_equal(
                    getattr(host, layer),
                    np.asarray(getattr(jsb, f"raster_{layer}"))[:n])
            np.testing.assert_array_equal(slots(host.instance_rows),
                                          np.asarray(jsb.instance_rows))
            np.testing.assert_array_equal(host.quad_records,
                                          np.asarray(jsb.quad_records))
            continue
        j, p = getattr(jsb, field), getattr(psb, field)
        if j is None or p is None:
            assert j is None and p is None, field
            continue
        j = np.asarray(j)
        p = p.numpy()
        if field == "instance_rows":
            p = slots(p)
        assert j.shape == p.shape, field
        np.testing.assert_array_equal(j, p, err_msg=field)
    assert pr.packer.alpha_cap == jr.packer.alpha_cap
    assert pr._sky_rec == jr._sky_rec
    assert pr.active_instances and len(pr.active_instances) == len(jr.active_instances)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_global_params_equal(name):
    jr, pr = _renderers(name)
    jcfg, pcfg = jr._config(), pr._config()
    for f in ("rt_width", "rt_height", "di_samples", "gi_samples",
              "max_lights", "max_reflections", "refraction_enabled",
              "alpha_cap", "k_primary", "tiled"):
        assert getattr(jcfg, f) == getattr(pcfg, f), f
    # The port sums 4 alpha layers a shadow ray, as RT64 sums every
    # layer; the JAX package keeps 1.
    assert (jcfg.k_shadow, pcfg.k_shadow) == (1, 4)
    jgp, pgp = jr._global_params(jcfg), pr._global_params(pcfg)
    for f in pfg.GlobalParams._fields:
        j, p = getattr(jgp, f), getattr(pgp, f)
        if f == "temporal_reset" and j is None:
            # The JAX view sets it only while a temporal upscaler runs;
            # the port's view always does (no upscaler here: False).
            j = np.bool_(False)
        # pixel_jitter stays on the host in the port: its f32 values.
        p = np.asarray(p, np.float32) if isinstance(p, tuple) else p.numpy()
        np.testing.assert_array_equal(np.asarray(j), p, err_msg=f)
