"""The port's 128-triangle Moller-Trumbore path (K3/K4 of
ops/tracer_cuda.py) against the JAX package's cluster-streaming kernels
(tracer_pallas._kernel / _shadow_kernel, run in interpret mode).

On the CPU the wrappers run the plain twins. Both sides form t, u and v
in the same f32 operation order, so the tolerances are tight: triangle
ids exactly equal except on rays where two candidates have bit-equal
keys (the packages' tie rules differ there; such rays are counted and
printed), bias exact, occlusion flags exactly equal, and t/u/v within
rtol 1e-6 / atol 1e-6 on at least 99.5 % of the rays and within 1e-5 on
all of them: XLA's compiled CPU code and torch's eager kernels round a
cancelling sum differently on about one ray in a thousand (measured:
largest difference 1.4e-6 absolute).

Scenes of 512 and 1,024 triangles lie far below the size switch, so the
tests set the switch constants (of both packages where the JAX wrappers
run too) to 0 for their own duration: the `streaming` fixture.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rt64tpu.ops import tracer as jtr
from rt64tpu.ops import tracer_pallas as jtp

from rt64tpu_torch.ops import tracer as ptr
from rt64tpu_torch.ops import tracer_cuda as tc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def streaming(monkeypatch):
    """Both packages take their 128-triangle path at any scene size."""
    monkeypatch.setattr(jtp, "VMEM_CLUSTER_BYTES", 0)
    monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 0)


def _random_scene_np(rng, t_total, alpha_frac=0.1, bias_frac=0.2):
    v0 = rng.uniform(-10, 10, (3, t_total)).astype(np.float32)
    v1 = v0 + rng.uniform(-3, 3, (3, t_total)).astype(np.float32)
    v2 = v0 + rng.uniform(-3, 3, (3, t_total)).astype(np.float32)
    valid = rng.uniform(size=t_total) > 0.05
    alpha = (rng.uniform(size=t_total) < alpha_frac) & valid
    no_cull = rng.uniform(size=t_total) < 0.5
    bias = np.where(
        rng.uniform(size=t_total) < bias_frac,
        rng.uniform(0, 2, t_total), 0.0,
    ).astype(np.float32)
    return dict(v0=v0, v1=v1, v2=v2, valid=valid, alpha=alpha,
                no_cull=no_cull, bias=bias)


def _random_rays_np(rng, n=1024, shadow=False):
    origins = rng.uniform(-15, 15, (3, n)).astype(np.float32)
    dirs = rng.normal(size=(3, n)).astype(np.float32)
    t_max = (rng.uniform(1.0, 30.0, n).astype(np.float32) if shadow
             else np.full(n, 1e5, np.float32))
    return origins, dirs, np.zeros(n, np.float32), t_max


def _jax_scene(s):
    a = {k: jnp.asarray(v) for k, v in s.items()}
    return jtr.TraceScene(**a, alpha_idx=jtr.compact_alpha(a["valid"], a["alpha"], 64))


def _port_scene(s):
    a = {k: torch.from_numpy(v) for k, v in s.items()}
    return ptr.TraceScene(**a, alpha_idx=ptr.compact_alpha(a["valid"], a["alpha"], 64))


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _by_entry_then_id(visits, entries):
    order = np.lexsort((visits, entries), axis=-1)
    return (np.take_along_axis(visits, order, -1),
            np.take_along_axis(entries, order, -1))


def _compare_opaque(jax_out, port_out, what):
    """tri exact off bit-equal keys; t, u, v at 1e-6 (99.5 %) and 1e-5
    (all); bias exact."""
    t_j, tri_j, u_j, v_j, b_j = (np.asarray(a) for a in jax_out)
    t_p, tri_p, u_p, v_p, b_p = (a.numpy() for a in port_out)
    differ = tri_j != tri_p
    ties = differ & (t_j == t_p)
    print(f"{what}: {int(ties.sum())} rays with bit-equal keys of "
          f"{tri_j.size}")
    assert not (differ & ~ties).any()
    same = ~differ
    hit = same & (tri_j >= 0)
    assert hit.mean() > 0.1
    for a, b in ((t_j, t_p), (u_j, u_p), (v_j, v_p)):
        tight = np.isclose(a[same], b[same], rtol=1e-6, atol=1e-6)
        assert tight.mean() >= 0.995, tight.mean()
        np.testing.assert_allclose(a[same], b[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(b_j[same], b_p[same])
    return tri_p


def test_switch_predicates_agree():
    """Both packages change tables at the same triangle bucket."""
    want = {16384: True, 26880: True, 27008: False, 32768: False, 65536: False}
    for t_total, resident in want.items():
        mats = jax.ShapeDtypeStruct((t_total // jtp.K_CS, jtp.WS_ROWS,
                                     3 * jtp.K_CS), jnp.float32)
        assert jtp._clusters_fit_vmem(mats) == resident, t_total
        assert tc.clusters_resident(t_total) == resident, t_total
    assert (tc.K_CS, tc.CLUSTER_SIZE, tc.GROUP_CLUSTERS, tc.BLOCK_RAYS) == (
        jtp.K_CS, jtp.CLUSTER_SIZE, jtp.GROUP_CLUSTERS, jtp.BLOCK_RAYS)
    assert tc.RESIDENT_TABLE_BYTES == jtp.VMEM_CLUSTER_BYTES


# 1,024 triangles (8 clusters) and 264 clusters: the JAX package orders
# rows of up to 256 clusters by rank and longer rows by argsort.
@pytest.mark.parametrize("t_total", [1024, 264 * 128])
def test_cluster_data_and_visit_lists_match(t_total):
    rng = np.random.default_rng(5)
    s = _random_scene_np(rng, t_total)
    # Triangles sorted along x, so clusters are slabs, and two coherent
    # ray blocks that each look down +z from a narrow x range: the cull
    # has something to cut.
    by_x = np.argsort(s["v0"][0], kind="stable")
    s = {k: v[..., by_x] for k, v in s.items()}
    n = 1024
    x0 = np.repeat(np.array([-8.0, 4.0], np.float32), n // 2)
    origins = np.stack([x0 + rng.uniform(0, 2, n), rng.uniform(-10, 10, n),
                        np.full(n, -20.0)]).astype(np.float32)
    dirs = np.stack([rng.normal(0, 0.02, n), rng.normal(0, 0.02, n),
                     np.ones(n)]).astype(np.float32)
    rays = (origins, dirs, np.zeros(n, np.float32), np.full(n, 1e5, np.float32))
    jtris, jlo, jhi = jtp.build_cluster_data(_jax_scene(s))
    ptris = tc.build_cluster_data(_port_scene(s))
    assert ptris.shape == (t_total // 128 + 1, tc.M_ROWS, tc.CLUSTER_SIZE)
    np.testing.assert_array_equal(np.asarray(jtris), ptris[:-1].numpy())
    assert (ptris[-1] == 0).all()  # the pad cluster
    assert (tc.M_V0, tc.M_E1, tc.M_E2, tc.M_BIAS, tc.M_ACTIVE, tc.M_NO_CULL,
            tc.M_ROWS) == (jtp.C_V0X, jtp.C_E1X, jtp.C_E2X, jtp.C_BIAS,
                           jtp.C_ACTIVE, jtp.C_NO_CULL, jtp.C_ROWS)
    plo, phi = tc.build_cluster_boxes(_port_scene(s), tc.CLUSTER_SIZE)
    np.testing.assert_array_equal(np.asarray(jlo), plo.numpy())
    np.testing.assert_array_equal(np.asarray(jhi), phi.numpy())
    # The 128-triangle path groups GROUP_CLUSTERS (8) clusters, the
    # default of both packages.
    jv, jc, je = jax.jit(lambda: jtp.block_visit_lists(
        *_jax(*rays), jlo, jhi, jtp.BLOCK_RAYS, bias_max=0.5))()
    pv, pc, pe = tc.block_visit_lists(*_port(*rays), plo, phi, bias_max=0.5)
    np.testing.assert_array_equal(np.asarray(jc), pc.numpy())
    assert (np.diff(pe.numpy(), axis=1) >= 0).all()  # front to back
    jv, je = _by_entry_then_id(np.asarray(jv), np.asarray(je))
    pv, pe = _by_entry_then_id(pv.numpy(), pe.numpy())
    np.testing.assert_array_equal(jv, pv)
    np.testing.assert_allclose(je, pe, rtol=1e-6, atol=1e-6)
    assert pc.min() > 0
    if t_total > 1024:
        assert pc.max() < t_total // 128  # the cull cut something
        # Smaller groups cull at least as well: the parameter is live.
        _, pc1, _ = tc.block_visit_lists(*_port(*rays), plo, phi,
                                         bias_max=0.5, group_clusters=1)
        assert (pc1 <= pc).all() and (pc1 < pc).any()


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("t_total", [512, 1024])
def test_k3_twin_matches_jax_kernel(streaming, t_total, cull):
    """The same kernel inputs through the JAX K3 (interpret mode) and
    the port's K3 wrapper, which on the CPU runs the plain twin."""
    rng = np.random.default_rng(t_total + cull)
    s = _random_scene_np(rng, t_total)
    p = tc.prepare_opaque(*_port(*_random_rays_np(rng)), _port_scene(s))
    assert p.mt and p.clusters.shape[1:] == (12, 128)
    want = jtp._trace_opaque_pallas_impl(
        *_jax(*(a.numpy() for a in p[:5])), cull, True)
    got = tc.trace_opaque_mt_blocks(*p[:5], cull)
    tri = _compare_opaque(want, got, f"K3 T={t_total} cull={cull}")
    # The port's plain reference tracer agrees on the winners too.
    rays = (p.rays8[0:3], p.rays8[3:6], p.rays8[6], p.rays8[7])
    _, tri_ref, _ = ptr.trace_opaque(*rays, _port_scene(s),
                                     cull_backface=cull, chunk=128)
    np.testing.assert_array_equal(tri_ref.numpy(), tri)


@pytest.mark.parametrize("t_total", [512, 1024])
def test_k4_twin_matches_jax_kernel(streaming, t_total):
    rng = np.random.default_rng(t_total)
    s = _random_scene_np(rng, t_total)
    p = tc.prepare_shadow(*_port(*_random_rays_np(rng, shadow=True)),
                          _port_scene(s))
    want = np.asarray(jtp._shadow_pallas_impl(
        *_jax(*(a.numpy() for a in p[:5])), True))
    got = tc.trace_shadow_mt_blocks(*p[:5]).numpy()
    np.testing.assert_array_equal(want, got)
    assert 0.05 < got.mean() < 0.95


@pytest.mark.parametrize("cull", [True, False])
def test_opaque_fn_beyond_the_switch(streaming, cull):
    """make_opaque_fn end to end on the K3 path, with a 700-ray partial
    block at t_max = 1e5."""
    rng = np.random.default_rng(11)
    s = _random_scene_np(rng, 512)
    rays = _random_rays_np(rng, n=700)
    assert not tc.clusters_resident(512)
    fn = jtp.make_opaque_fn(interpret=True)
    jscene = _jax_scene(s)
    t_j, tri_j, uv_j, b_j = jax.jit(
        lambda: fn(*_jax(*rays), jscene, cull_backface=cull))()
    before = tc.launch_counts.opaque_mt_launches
    t_p, tri_p, uv_p, b_p = tc.make_opaque_fn()(
        *_port(*rays), _port_scene(s), cull_backface=cull)
    assert tc.launch_counts.opaque_mt_launches == before  # CPU: the twin
    assert tri_p.shape == (700,) and uv_p.shape == (700, 2)
    _compare_opaque((t_j, tri_j, uv_j[:, 0], uv_j[:, 1], b_j),
                    (t_p, tri_p, uv_p[:, 0], uv_p[:, 1], b_p),
                    f"opaque_fn cull={cull}")
    assert (t_p[tri_p < 0] == ptr._BIG).all()


def test_shadow_fn_beyond_the_switch(streaming):
    """700 rays at t_max = 1e5: on a partial block the JAX wrapper
    lowers EVERY ray's t_max by 1 (tracer_pallas.py:1466 pads, then
    subtracts from the whole vector), which at 1e5 changes no result;
    the port lowers only the padding's."""
    rng = np.random.default_rng(12)
    s = _random_scene_np(rng, 512)
    rays = _random_rays_np(rng, n=700)
    fn = jtp.make_shadow_opaque_fn(interpret=True)
    jscene = _jax_scene(s)
    _, tri_j, _, _ = jax.jit(lambda: fn(*_jax(*rays), jscene))()
    t_p, tri_p, _, _ = tc.make_shadow_opaque_fn()(*_port(*rays), _port_scene(s))
    blocked = np.asarray(tri_j) >= 0
    assert tri_p.shape == (700,)
    np.testing.assert_array_equal(blocked, tri_p.numpy() >= 0)
    assert 0.05 < blocked.mean() < 0.95
    np.testing.assert_array_equal(t_p.numpy() == 0.0, blocked)


def test_size_switch_picks_the_table(monkeypatch):
    """Below the switch prepare_* builds the Woop table, beyond it the
    Moller-Trumbore table, and the two paths agree on the winners."""
    rng = np.random.default_rng(13)
    s = _port_scene(_random_scene_np(rng, 512))
    rays = _port(*_random_rays_np(rng))
    small = tc.prepare_opaque(*rays, s)
    assert not small.mt and small.clusters.shape == (512 // 64 + 1, 14, 64)
    monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 0)
    large = tc.prepare_opaque(*rays, s)
    assert large.mt and large.clusters.shape == (512 // 128 + 1, 12, 128)
    _, tri_w, _, _, _ = tc.trace_opaque_blocks(*small[:5], True)
    _, tri_m, _, _, _ = tc.trace_opaque_mt_blocks(*large[:5], True)
    assert (tri_w == tri_m).float().mean().item() >= 0.999
    # Each wrapper holds its own table's shape.
    with pytest.raises(ValueError):
        tc.trace_opaque_mt_blocks(*small[:5], True)
    with pytest.raises(ValueError):
        tc.trace_shadow_blocks(*large[:5])


def test_k3_tie_rule_duplicated_coplanar_triangles(streaming):
    """Exactly equal keys on the K3 path: smallest biased key, then the
    largest triangle id, within a cluster and across clusters, whatever
    the visit order."""
    t_total = 512
    z = lambda: np.zeros((3, t_total), np.float32)
    v0, v1, v2 = z(), z(), z()
    valid = np.zeros(t_total, bool)
    tri_a = np.array([[-4, -4, 0], [4, -4, 0], [0, 4, 0]], np.float32).T
    for i in (3, 9, 130, 400):  # clusters 0, 0, 1, 3
        v0[:, i], v1[:, i], v2[:, i] = tri_a[:, 0], tri_a[:, 1], tri_a[:, 2]
        valid[i] = True
    s = dict(v0=v0, v1=v1, v2=v2, valid=valid,
             alpha=np.zeros(t_total, bool), no_cull=np.ones(t_total, bool),
             bias=np.zeros(t_total, np.float32))
    n = 512
    rng = np.random.default_rng(2)
    xy = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    origins = np.stack([xy[0], xy[1], np.full(n, -10, np.float32)])
    dirs = np.tile(np.array([[0], [0], [1]], np.float32), (1, n))
    rays = (origins, dirs, np.zeros(n, np.float32), np.full(n, 1e5, np.float32))
    p = tc.prepare_opaque(*_port(*rays), _port_scene(s))
    for cull in (True, False):
        t, tri, _, _, _ = tc.trace_opaque_mt_blocks(*p[:5], cull)
        assert (tri.numpy() == 400).all()
        np.testing.assert_allclose(t.numpy(), 10.0, rtol=1e-6)
    # Reversed visit order, same winners.
    k = int(p.counts[0])
    rev = p.visits.clone()
    rev[0, :k] = p.visits[0, :k].flip(0)
    _, tri, _, _, _ = tc.trace_opaque_mt_blocks(
        p.rays8, p.clusters, rev, p.counts, p.entries, True)
    assert (tri.numpy() == 400).all()
    # The depth bias decides before the id does.
    s["bias"][9] = 0.5
    p = tc.prepare_opaque(*_port(*rays), _port_scene(s))
    _, tri, _, _, bias = tc.trace_opaque_mt_blocks(*p[:5], True)
    assert (tri.numpy() == 9).all()
    np.testing.assert_allclose(bias.numpy(), 0.5)
