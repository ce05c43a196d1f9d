"""The check on tiny cells on the CPU: the port agrees with the plain
reference on the walk's frames, and the control (the reference a
precision step below, in the program's place) and each fault the cells
can have, planted in the program, come out not correct: among them a
pass of the frame graph left out (shadow rays, GI, a reflection bounce)
and the upscale slot's inputs or history gone wrong."""

import pytest
import torch

from portbench import run as pr

CELLS = ("tiny-fsr.walk", "tiny-dlss.walk")


def _run(bench, cell, **kw):
    return pr.run(bench, cell, 20260917 + 2**31, 0.0, False, device="cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(tiny_bench, cell):
    out = _run(tiny_bench, cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["pick_miss_pct"]["value"] <= 0.5
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_bench, cell):
    out = _run(tiny_bench, cell, with_control=True)
    assert out["correct"] and not out["control"]["correct"], out["control"]


def test_stale_scene_fails(tiny_bench, monkeypatch):
    """A step that returns its state unchanged: the scene packed once and
    never again, so the character and the moved foliage stay where the
    first frame put them."""
    from rt64tpu_torch.pipeline.view import ViewRenderer

    update = ViewRenderer.update
    monkeypatch.setattr(ViewRenderer, "update", lambda self: (
        update(self) if self._sb is None else None))
    out = _run(tiny_bench, "tiny-fsr.walk")
    assert not out["correct"], out["checks"]


def test_half_the_rays_left_out_fails(tiny_bench, monkeypatch):
    """Half of the frame's primary rays left out (sent up, where they
    hit nothing)."""
    from rt64tpu_torch.pipeline import framegraph as fg

    rays = fg.primary_rays

    def half(cfg, gp, row_offset=0):
        pix, origins, dirs = rays(cfg, gp, row_offset)
        dirs = dirs.clone()
        dirs[:, 1::2] = torch.tensor([0.0, 1.0, 0.0])[:, None]
        return pix, origins, dirs

    monkeypatch.setattr(fg, "primary_rays", half)
    out = _run(tiny_bench, "tiny-fsr.walk")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_present_fails(tiny_bench, cell, monkeypatch):
    """An answer altered where it is produced: a block of the presented
    frame changed by the RGB8 packing."""
    from rt64tpu_torch.pipeline import framegraph as fg

    present = fg.present_rgb8

    def altered(image):
        rgb = present(image).clone()
        rgb[:4, :4] = 255 - rgb[:4, :4]
        return rgb

    monkeypatch.setattr(fg, "present_rgb8", altered)
    out = _run(tiny_bench, cell)
    assert not out["correct"], out["checks"]


def _planted(tiny_bench, monkeypatch, module, name, fn, cell="tiny-dlss.walk"):
    monkeypatch.setattr(module, name, fn)
    return _run(tiny_bench, cell)


def test_shadow_rays_left_out_fail(tiny_bench, monkeypatch):
    """Direct light with every shadow ray taken as unoccluded."""
    from rt64tpu_torch.ops import lighting

    trace = lighting.trace_plans

    def unshadowed(plans, *args, **kw):
        factors, dropped = trace(plans, *args, **kw)
        return [torch.ones_like(f) for f in factors], dropped

    out = _planted(tiny_bench, monkeypatch, lighting, "trace_plans", unshadowed,
                   cell="tiny-fsr.walk")
    assert not out["correct"], out["checks"]
    assert out["checks"]["shade_miss_pct"]["value"] > 1.0


def test_gi_left_out_fails(tiny_bench, monkeypatch):
    """The GI pass returning its ambient fallback."""
    from rt64tpu_torch.pipeline import framegraph as fg

    gi = fg.indirect_pass

    def ambient_only(sb, tri_rows, trace_scene, cfg, *args, **kw):
        import dataclasses
        return gi(sb, tri_rows, trace_scene,
                  dataclasses.replace(cfg, gi_samples=0), *args, **kw)

    out = _planted(tiny_bench, monkeypatch, fg, "indirect_pass", ambient_only)
    assert not out["correct"], out["checks"]
    assert out["checks"]["shade_miss_pct"]["value"] > 1.0


def test_reflection_bounce_left_out_fails(tiny_bench, monkeypatch):
    """Each reflection bounce returning the state it was given."""
    from rt64tpu_torch.pipeline import framegraph as fg

    def no_bounce(sb, tri_rows, trace_scene, cfg, gp, state, *args, **kw):
        return state, torch.zeros((), dtype=torch.int64)

    out = _planted(tiny_bench, monkeypatch, fg, "reflection_pass", no_bounce)
    assert not out["correct"], out["checks"]


def test_stale_fsr_history_fails(tiny_bench, monkeypatch):
    """The FSR slot's history never updated: every frame accumulates
    onto a fresh one."""
    from rt64tpu_torch.pipeline import framegraph as fg

    upscale = fg.upscale
    monkeypatch.setattr(fg, "upscale", lambda cfg, gp, g, rt, temporal=None:
                        upscale(cfg, gp, g, rt, None))
    out = _run(tiny_bench, "tiny-fsr.walk")
    assert not out["correct"], out["checks"]


def test_flow_left_out_fails(tiny_bench, monkeypatch):
    """The FSR slot fed no motion: a zero flow plane. (The DLSS slot's
    shipped weights read no flow: its first layer's flow weights are
    zero.)"""
    from rt64tpu_torch.pipeline import framegraph as fg

    primary = fg.primary_pass

    def still(*args, **kw):
        g, plan, lit = primary(*args, **kw)
        return g._replace(flow=torch.zeros_like(g.flow)), plan, lit

    out = _planted(tiny_bench, monkeypatch, fg, "primary_pass", still,
                   cell="tiny-fsr.walk")
    assert not out["correct"], out["checks"]
