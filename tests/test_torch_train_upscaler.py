"""The port's upscaler trainer against the JAX package's, on the CPU.

- Camera draws: bit for bit the JAX trainer's (its render_pairs run on
  stand-in scenes that record each set_perspective).
- The low-res planes: the port feeds framegraph.to_image of depth, flow
  and reactive; at a tiled size (8x128: two 8x64 tiles side by side) the
  JAX trainer's reshape of the same tile-ordered planes differs.
- Each pair is a camera cut: the port's flow planes are zero (a still
  camera's on a static scene) though the camera moved between pairs;
  the JAX trainer re-poses its views with can_reproject on, so its flow
  is the motion from the previous pair's unrelated camera.
- From the same Flax-initialised parameters (carried across as numpy,
  every layer's kernel and bias made non-zero so every gradient is), a
  batch of 2 at 16x16 -> 32x32: the loss within 1e-5 and every gradient
  within 1e-2 of its largest magnitude (bf16 convolutions, rounded in
  another order). The JAX package's bias gradients sum their bf16
  cotangent in bf16 on the CPU (XLA's reduce keeps the operand's type;
  its final bias gradient is off by half), so each bias gradient is held
  against the exact sum of the JAX package's own cotangent of that layer,
  taken through a Flax method interceptor.
- Two clip-plus-Adam steps from the same parameters and gradients: the
  parameters within 1e-7 of optax's update (1e-4 of the learning rate).
  The cosine schedule: optax's to 1e-7 at every step.
- Weight files: the port's save_params read by the JAX package's
  get_params, and a JAX np.savez read by the port's load_params, equal
  exactly. The pair cache round-trips in the JAX trainer's layout.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from rt64tpu.models import learned_upscaler as jlu
from rt64tpu.models import train_upscaler as jtr

from rt64tpu_torch.models import learned_upscaler as plu
from rt64tpu_torch.models import train_upscaler as ptr
from rt64tpu_torch.ops import filters
from rt64tpu_torch.ops import math3d as pmath3d
from rt64tpu_torch.pipeline import framegraph as fg

B, H, W, DH, DW = 2, 16, 16, 32, 32
GRAD_TOL = 1e-2  # of the gradient's largest magnitude (bf16 operands)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _StandIn:
    """A stand-in for build_sample_scene and build_castle_scene in the JAX
    trainer's render_pairs: the view records every camera, and its last
    frame holds the given planes."""

    def __init__(self, frame=None):
        self.cameras = []
        self.can_reproject = []
        self.frame = frame

    def __call__(self, width, height, **kw):
        n = width * height
        frame = self.frame or types.SimpleNamespace(
            rt_output=np.zeros((3, height, width), np.float32),
            gbuffers=types.SimpleNamespace(
                depth=np.zeros(n, np.float32), flow=np.zeros((2, n), np.float32),
                reactive=np.zeros(n, np.float32)))
        view = types.SimpleNamespace(_renderer=types.SimpleNamespace(_last=frame))
        def set_perspective(vm, fov, near, far, can_reproject=True):
            self.cameras.append((np.array(vm), fov))
            self.can_reproject.append(can_reproject)

        view.set_perspective = set_perspective
        return types.SimpleNamespace(draw=lambda: None), None, view


def _jax_render_pairs(monkeypatch, stand_in, n, kind, seed0, **kw):
    from rt64tpu.utils import castle_scene, testscenes

    monkeypatch.setattr(testscenes, "build_sample_scene", stand_in)
    monkeypatch.setattr(castle_scene, "build_castle_scene", stand_in)
    return jtr.render_pairs(n, scene_kind=kind, seed0=seed0, **kw)


@pytest.mark.parametrize("kind,seed0", [("sample", 7), ("castle", 1007)])
def test_camera_draws_match_jax(monkeypatch, kind, seed0):
    stand_in = _StandIn()
    _jax_render_pairs(monkeypatch, stand_in, 4, kind, seed0)
    want = stand_in.cameras[0::2]  # each camera draws lo, then hi
    got = ptr.camera_draws(4, kind, seed0)
    assert len(got) == len(want) == 4
    for (vm, fov), (jvm, jfov) in zip(got, want):
        assert vm.dtype == jvm.dtype and np.array_equal(vm, jvm)
        assert fov == jfov


def test_pairs_feed_image_planes(monkeypatch):
    """The port's low-res planes are to_image of the frame's planes
    (frame_inputs), in a pair and on a moving camera's frame; the JAX
    trainer, fed the moving frame, reshapes the tile order."""
    from rt64tpu_torch.utils import testscenes

    lo, hi = (8, 128), (16, 256)
    built = []
    original = testscenes.build_sample_scene

    def recording(**kw):
        out = original(**kw)
        built.append(out)
        return out

    monkeypatch.setattr(testscenes, "build_sample_scene", recording)
    # Two cameras: the frame holds the second one's planes.
    _, (inputs, target) = ptr.render_pairs(2, "sample", lo=lo, hi=hi, seed0=3,
                                           device="cpu")
    dev, _, view = built[0]

    def last_planes():
        out, cfg = view._renderer._last, view._renderer._last_cfg
        assert cfg.tiled and (cfg.rt_height, cfg.rt_width) == lo
        g = out.gbuffers
        return out, cfg, dict(depth=g.depth, flow=g.flow, reactive=g.reactive)

    out, cfg, cut = last_planes()
    for k, plane in cut.items():
        assert np.array_equal(inputs[k], fg.to_image(cfg, plane).numpy()), k
    assert np.array_equal(inputs["rt_color"], out.rt_output.numpy())
    assert target.shape == (3,) + hi

    # The same view turned, with reprojection on: a moving camera's flow.
    view.set_perspective(pmath3d.turn_view(view.view_matrix, 0.03, 0.05),
                         view.fov_radians, view.near_dist, view.far_dist, True)
    dev.draw()
    moved = ptr.frame_inputs(view)
    out, cfg, planes = last_planes()
    for k, plane in planes.items():
        assert np.array_equal(moved[k], fg.to_image(cfg, plane).numpy()), k
    assert np.array_equal(moved["rt_color"], out.rt_output.numpy())
    assert moved["flow"].min() != moved["flow"].max()

    frame = types.SimpleNamespace(
        rt_output=out.rt_output.numpy(),
        gbuffers=types.SimpleNamespace(**{k: p.numpy() for k, p in planes.items()}))
    _, (jinputs, _) = _jax_render_pairs(monkeypatch, _StandIn(frame), 2,
                                        "sample", 3, lo=lo, hi=hi)
    scrambled = [k for k in planes if not np.array_equal(jinputs[k], moved[k])]
    assert all(jinputs[k].shape == moved[k].shape for k in planes)
    # A constant plane survives any reshape; the others are scrambled.
    assert scrambled == [k for k in planes if moved[k].min() != moved[k].max()]
    assert {"depth", "flow"} <= set(scrambled)


def test_pairs_are_camera_cuts(monkeypatch):
    """Every pair's flow is a still camera's (zero on the static sample
    scene), though the camera moves from pair to pair; the JAX trainer
    keeps reprojection on across its pairs' unrelated cameras."""
    pairs = ptr.render_pairs(3, "sample", lo=(8, 64), hi=(16, 128), seed0=5,
                             device="cpu")
    cams = ptr.camera_draws(3, "sample", 5)
    assert not np.array_equal(cams[0][0], cams[1][0])
    for i, (inputs, _) in enumerate(pairs):
        assert inputs["flow"].shape == (2, 8, 64)
        assert not inputs["flow"].any(), f"pair {i}: flow {abs(inputs['flow']).max()}"
        assert inputs["depth"].min() != inputs["depth"].max()
    stand_in = _StandIn()
    _jax_render_pairs(monkeypatch, stand_in, 3, "sample", 5)
    assert stand_in.can_reproject == [True] * 6


def _params(seed=3):
    """Flax-initialised parameters with every kernel and bias made
    non-zero (the init zeroes the head and the biases): (JAX tree,
    leaves as numpy)."""
    rng = np.random.default_rng(seed)
    tree = jlu._model.init(jax.random.PRNGKey(0), jnp.zeros((8, 8, 7)))
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    leaves = [np.asarray(x) for x in leaves]
    for i in (0, 2, 4, 6, 8, 9):  # the biases and the head's kernel
        leaves[i] = rng.normal(0, 0.05, leaves[i].shape).astype(np.float32)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in leaves]), leaves


def _port_net(leaves):
    pairs = [(leaves[k].transpose(3, 2, 0, 1), leaves[b])
             for b, k in zip(range(0, 10, 2), range(1, 10, 2))]
    return plu.set_params(plu.UpscaleNet(), pairs)


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    return [(dict(rt_color=u(0, 1, 3, H, W), depth=u(1, 50, H, W),
                  flow=u(-2, 2, 2, H, W), reactive=u(0, 1, H, W)),
             u(0, 1, 3, DH, DW)) for _ in range(B)]


def test_loss_and_gradients_match_jax():
    tree, leaves = _params()
    batch = _batch()
    stacked = tuple(jnp.asarray(np.stack([i[k] for i, _ in batch]))
                    for k in ptr.INPUT_KEYS)
    targets = jnp.asarray(np.stack([t for _, t in batch]))

    # The JAX package's loss, its parameter gradients and its cotangent at
    # each convolution's output (a zero added there through a Flax method
    # interceptor, while the net is traced afresh inside one jit). Summed
    # exactly, the cotangent is the bias gradient without the bf16 reduce.
    shapes = {f"Conv_{i}": (DH, DW, c) for i, c in enumerate((32, 32, 32, 16, 3))}

    def perturbed(params, eps):
        def add(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Conv) and context.method_name == "__call__":
                out = out + eps[context.module.name]
            return out

        with nn.intercept_methods(add):
            return jtr.loss_fn(params, stacked, targets, DH, DW)

    run = jlu._run
    jlu._run = run.__wrapped__
    try:
        loss_j, (grads_j, cot) = jax.jit(jax.value_and_grad(
            perturbed, argnums=(0, 1)))(
            tree, {k: jnp.zeros(s, jnp.bfloat16) for k, s in shapes.items()})
    finally:
        jlu._run = run
    grads_j = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads_j)]

    net = _port_net(leaves)
    pstacked, ptargets = ptr.stack_batch(batch, "cpu")
    loss = ptr.loss_fn(net, pstacked, ptargets, DH, DW)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5
    for i, conv in enumerate(net.convs):
        want_w = grads_j[2 * i + 1].transpose(3, 2, 0, 1)
        want_b = np.asarray(cot[f"Conv_{i}"], np.float64).sum((0, 1))
        for got, want in ((conv.weight.grad.numpy(), want_w),
                          (conv.bias.grad.numpy(), want_b)):
            scale = np.abs(want).max()
            assert scale > 0
            assert np.abs(got - want).max() <= GRAD_TOL * scale, i


def test_adam_step_matches_optax():
    """clip_by_global_norm(1) + adam at the schedule's first two rates, from
    the same parameters and gradients (global norm above 1: the clip
    acts)."""
    _, leaves = _params()
    rng = np.random.default_rng(5)
    grads = [rng.normal(0, 0.5, x.shape).astype(np.float32) for x in leaves]
    lr, steps = 1e-3, 50
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
        optax.cosine_decay_schedule(lr, steps, alpha=0.05)))
    jparams = [jnp.asarray(x) for x in leaves]
    state = opt.init(jparams)
    net = _port_net(leaves)
    popt = ptr.make_optimizer(net, lr)
    schedule = ptr.cosine_decay(lr, steps)

    @jax.jit
    def step_fn(g, st, p):
        updates, st = opt.update(g, st)
        return optax.apply_updates(p, updates), st

    for step in range(2):
        jparams, state = step_fn([jnp.asarray(g) for g in grads], state, jparams)
        for i, conv in enumerate(net.convs):
            conv.bias.grad = torch.from_numpy(grads[2 * i].copy())
            conv.weight.grad = torch.from_numpy(
                grads[2 * i + 1].transpose(3, 2, 0, 1).copy())
        ptr.apply_update(net, popt, schedule(step))
        for i, conv in enumerate(net.convs):
            got_w = conv.weight.detach().numpy().transpose(2, 3, 1, 0)
            np.testing.assert_allclose(got_w, np.asarray(jparams[2 * i + 1]),
                                       rtol=0, atol=1e-7)
            np.testing.assert_allclose(conv.bias.detach().numpy(),
                                       np.asarray(jparams[2 * i]), rtol=0,
                                       atol=1e-7)


def test_cosine_schedule_matches_optax():
    lr, steps = 1e-3, 400
    want = optax.cosine_decay_schedule(lr, steps, alpha=0.05)
    got = ptr.cosine_decay(lr, steps)
    for step in range(steps + 3):
        assert abs(got(step) - float(want(step))) <= 1e-7


def test_weight_files_cross_read(tmp_path, monkeypatch):
    _, leaves = _params()
    path = str(tmp_path / "port.npz")
    plu.save_params(path, _port_net(leaves))
    monkeypatch.setattr(jlu, "_PARAMS_CACHE", path)
    monkeypatch.setattr(jlu, "_params", None)
    read = [np.asarray(x) for x in jax.tree_util.tree_leaves(jlu.get_params())]
    for a, b in zip(read, leaves):
        assert a.dtype == np.float32 and np.array_equal(a, b)

    jpath = str(tmp_path / "jax.npz")
    np.savez(jpath, **{f"{i:04d}": x for i, x in enumerate(leaves)})
    for i, (w, b) in enumerate(plu.load_params(jpath)):
        assert np.array_equal(w, leaves[2 * i + 1].transpose(3, 2, 0, 1))
        assert np.array_equal(b, leaves[2 * i])


def test_serving_net_unchanged_by_the_weight_cast():
    """get_net's bf16 weights: the forward casts nothing, so serving
    gives the bytes of the shipped weights cast once to bf16."""
    net = plu.get_net(torch.device("cpu"))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 7, 8, 16)).astype(np.float32))
    h = x.to(torch.bfloat16)
    for i, conv in enumerate(net.convs):
        assert conv.weight.dtype == torch.bfloat16
        h = torch.nn.functional.conv2d(h, conv.weight, None, conv.stride,
                                       conv.padding, conv.dilation)
        h = h + conv.bias[None, :, None, None]
        h = torch.relu(h) if i < 4 else h
    assert torch.equal(net(x), h.float())


def test_fresh_net_starts_at_the_bilinear_upscale():
    a, b = ptr.fresh_net(1), ptr.fresh_net(1)
    for ca, cb in zip(a.convs, b.convs):
        assert torch.equal(ca.weight, cb.weight) and ca.weight.dtype == torch.float32
    assert not torch.equal(a.convs[0].weight, ptr.fresh_net(2).convs[0].weight)
    assert not a.convs[-1].weight.any()
    stacked, _ = ptr.stack_batch(_batch(), "cpu")
    with torch.no_grad():
        out = ptr.forward(a, stacked, DH, DW)
    want = filters.bilinear_resize(stacked[0].reshape(-1, H, W), DH, DW)
    assert torch.equal(out, want.reshape(B, 3, DH, DW))


def test_training_lowers_the_loss():
    batch = _batch()
    stacked, targets = ptr.stack_batch(batch, "cpu")
    net = ptr.fresh_net(0)
    opt = ptr.make_optimizer(net, 1e-3)
    schedule = ptr.cosine_decay(1e-3, 20)
    losses = [float(ptr.train_step(net, opt, schedule(s), stacked, targets, DH, DW))
              for s in range(20)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    s_net, s_bil = ptr.evaluate(net, batch, DH, DW, "cpu")
    assert 0 < s_bil <= 1 and 0 < s_net <= 1


def test_fit_zeroes_the_unseen_inputs():
    """fit zeroes Conv_0's weights of the channels that are zero in every
    pair (the flow of camera cuts), which then stay zero: the trained net
    ignores the flow of a moving camera. The other weights train."""
    batch = _batch()
    for inputs, _ in batch:
        inputs["flow"] = np.zeros_like(inputs["flow"])
    net = ptr.fresh_net(0)
    before = [c.weight.detach().clone() for c in net.convs]
    losses = [float(x) for x in ptr.fit(net, batch, 5, 1e-3, "cpu")]
    assert len(losses) == 5 and losses[-1] < losses[0]
    w0 = net.convs[0].weight.detach()
    assert not w0[:, 4:6].any()
    for c in (0, 1, 2, 3, 6):
        assert (w0[:, c] != before[0][:, c]).any(), c
    for conv, b in zip(net.convs[1:], before[1:]):
        assert not torch.equal(conv.weight, b)
    stacked, _ = ptr.stack_batch(batch, "cpu")
    assert ptr.zero_unseen_inputs(net, stacked).tolist() == [False] * 4 + [True] * 2 + [False]


def test_pair_cache_round_trip(tmp_path):
    batch = _batch()
    path = str(tmp_path / "pairs.npz")
    ptr.save_pairs(path, batch, ["sample", "castle"])
    z = np.load(path)
    assert sorted(z.files) == sorted(
        ["n", "kinds"] + [f"{i}_{k}" for i in range(B)
                          for k in ptr.INPUT_KEYS + ("target",)])
    read, kinds = ptr.load_pairs(path)
    assert kinds == ["sample", "castle"]
    for (ia, ta), (ib, tb) in zip(read, batch):
        assert np.array_equal(ta, tb)
        assert all(np.array_equal(ia[k], ib[k]) for k in ptr.INPUT_KEYS)
    held = ptr.hold_out(read, kinds)
    assert len(held) == 2 and not read


def test_out_has_no_default():
    with pytest.raises(SystemExit):
        ptr.main(["--device", "cpu", "--steps", "1"])


def test_main_trains_from_a_pair_cache(tmp_path, capsys):
    """The command line on the CPU from a cache of 2 pairs of each of
    three kinds (one held out each): it writes only --out, which
    load_params reads."""
    batch = _batch() * 3
    cache = str(tmp_path / "pairs.npz")
    ptr.save_pairs(cache, batch, ["sample"] * 2 + ["castle"] * 2 + ["castle_gi"] * 2)
    out = str(tmp_path / "weights.npz")
    ptr.main(["--device", "cpu", "--steps", "3", "--data", cache, "--out", out])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["pairs.npz", "weights.npz"]
    params = plu.load_params(out)
    assert [w.shape for w, _ in params] == [c.weight.shape for c in plu.UpscaleNet().convs]
    assert "held-out SSIM" in capsys.readouterr().out
