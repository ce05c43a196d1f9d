"""Train the learned upscaler (the DLSS-slot model) on rendered pairs.

Self-supervised from the renderer itself: each sample renders the same
scene and camera at low resolution (network input: colour, depth, flow,
reactive) and at the target resolution (ground truth), and the CNN
learns the residual over the bilinear upscale. The port of the JAX
package's trainer (rt64tpu/models/train_upscaler.py), on the CUDA card:

    python3 -m rt64tpu_torch.models.train_upscaler --out build/upscaler.npz

The same camera draws, corpus (sample, castle, castle GI), loss, Adam
with global-norm clipping and cosine decay, and weight file layout (the
JAX package reads the file too). The shipped weights,
models/_upscaler_params.npz, are fit's net at 32 pairs a kind and 2,000
steps (scripts/retrain_study.py drew them, and the held-out comparison
that chose them, on still and moving cameras). Three differences, all faults of the JAX
trainer (ROADMAP queue 3), and the zeroing that the second calls for:
- the low-res depth, flow and reactive planes go through
  framegraph.to_image, as serving feeds them; the JAX trainer reshapes
  the tile-ordered planes of its 96x128 frames, which scrambles them;
- each pair is a camera cut (set_perspective with can_reproject off):
  its flow plane is that of a still camera, zero on these static
  scenes, as serving feeds it on a still camera or after a cut; the
  JAX trainer re-poses the view with can_reproject on, so each pair's
  flow is the motion from the previous pair's unrelated random camera
  (hundreds to millions of pixels); so fit first zeroes Conv_0's
  weights of the flow channels (zero_unseen_inputs): no gradient
  reaches them, and at their random init the served net would respond
  to the flow of a moving camera, which it never learned from;
- --out has no default: a run never overwrites the shipped weights
  unless it is asked to.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from rt64tpu_torch.models import learned_upscaler as lu
from rt64tpu_torch.ops import filters

INPUT_KEYS = ("rt_color", "depth", "flow", "reactive")
CLIP_NORM = 1.0
BETAS = (0.9, 0.999)
EPS = 1e-8
COSINE_ALPHA = 0.05
# Flax's default kernel init (lecun_normal): a normal truncated to two
# standard deviations, scaled to variance 1 / fan_in; this constant is
# the std of the standard normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def camera_draws(n: int, scene_kind: str = "sample", seed0: int = 0):
    """The JAX trainer's n randomised cameras, in its draw order:
    [(view matrix (4, 4) f32, fov radians)]. Cameras orbit the scene and
    jitter in height, distance, look target and fov."""
    from rt64tpu_torch.ops import math3d

    rng = np.random.default_rng(seed0)
    cams = []
    for _ in range(n):
        angle = rng.uniform(0, 2 * np.pi)
        if scene_kind == "castle":
            height = rng.uniform(8.0, 20.0)
            dist = rng.uniform(40.0, 80.0)
            target_pt = (rng.uniform(-4, 4), 6.0 + rng.uniform(-2, 2),
                         rng.uniform(-4, 4))
        else:
            height = rng.uniform(2.0, 5.0)
            dist = rng.uniform(7.0, 11.0)
            target_pt = (rng.uniform(-1, 1), 1.2 + rng.uniform(-0.5, 0.5),
                         rng.uniform(-1, 1))
        eye = (dist * np.sin(angle), height, dist * np.cos(angle))
        vm = math3d.look_at_rh(eye, target_pt, (0.0, 1.0, 0.0))
        fov = rng.uniform(38.0, 52.0) * np.pi / 180.0
        cams.append((vm, fov))
    return cams


def scene_views(scene_kind: str = "sample", lo=(96, 128), hi=(192, 256),
                gi: int = 0, device=None):
    """{"lo": (device, view), "hi": (device, view)}: the scene built at
    each size. scene_kind "sample" or "castle"; gi=1 renders with
    one-bounce GI. device: None for the CUDA card."""
    views = {}
    for tag, (h, w) in (("lo", lo), ("hi", hi)):
        if scene_kind == "castle":
            from rt64tpu_torch.utils.castle_scene import build_castle_scene

            dev, _, view = build_castle_scene(width=w, height=h, gi_samples=gi,
                                              device=device)
        else:
            from rt64tpu_torch.utils.testscenes import build_sample_scene

            dev, _, view = build_sample_scene(width=w, height=h, gi_samples=gi,
                                              device=device)
        views[tag] = (dev, view)
    return views


def frame_inputs(view):
    """The net's inputs from the view's last frame, as numpy: rt_color
    (3, h, w), and the depth (h, w), flow (2, h, w) and reactive (h, w)
    planes through framegraph.to_image, as serving feeds them."""
    from rt64tpu_torch.pipeline.framegraph import to_image

    out, cfg = view._renderer._last, view._renderer._last_cfg
    g = out.gbuffers
    host = lambda t: t.cpu().numpy()
    return dict(rt_color=host(out.rt_output),
                depth=host(to_image(cfg, g.depth)),
                flow=host(to_image(cfg, g.flow)),
                reactive=host(to_image(cfg, g.reactive)))


def render_pairs(n: int, scene_kind: str = "sample", lo=(96, 128),
                 hi=(192, 256), seed0: int = 0, gi: int = 0, device=None):
    """n (inputs, target) pairs from camera_draws, as numpy: inputs are
    the low-res frame's frame_inputs; the target is the high-res frame's
    rt_color. Each (kind, size) scene is built once (scene_views) and
    only the camera moves, each pair a camera cut (no reprojection from
    the previous pair's camera). device: None for the CUDA card."""
    views = scene_views(scene_kind, lo, hi, gi, device)
    pairs = []
    for vm, fov in camera_draws(n, scene_kind, seed0):
        for dev, view in views.values():
            view.set_perspective(vm, fov, 0.1, 1000.0, False)
            dev.draw()
        pairs.append((frame_inputs(views["lo"][1]),
                      frame_inputs(views["hi"][1])["rt_color"]))
    return pairs


def save_pairs(path: str, batch, kinds) -> None:
    """The pair cache in the JAX trainer's .npz layout: n, kinds, then
    {i}_{key} for the inputs and {i}_target."""
    flat = {"n": np.int32(len(batch)), "kinds": np.asarray(kinds)}
    for i, (inputs, target) in enumerate(batch):
        for k, v in inputs.items():
            flat[f"{i}_{k}"] = v
        flat[f"{i}_target"] = target
    np.savez(path, **flat)


def load_pairs(path: str):
    """(batch, kinds) from a pair cache of either trainer. A cache
    without kinds (an older JAX one) splits into equal thirds."""
    z = np.load(path)
    batch = [({k: z[f"{i}_{k}"] for k in INPUT_KEYS}, z[f"{i}_target"])
             for i in range(int(z["n"]))]
    if "kinds" in z:
        kinds = [str(k) for k in z["kinds"]]
    else:
        third = max(1, len(batch) // 3)
        kinds = ["k%d" % (i // third) for i in range(len(batch))]
    return batch, kinds


def stack_batch(batch, device):
    """List of (inputs, target) -> ((rt_color, depth, flow, reactive),
    targets), each stacked on a leading batch axis on `device`."""
    col = lambda k: torch.from_numpy(np.stack([i[k] for i, _ in batch])).to(device)
    targets = torch.from_numpy(np.stack([t for _, t in batch])).to(device)
    return tuple(col(k) for k in INPUT_KEYS), targets


def net_input(stacked):
    """(B, 7, h, w): the stacked planes in the net's channel order:
    rt_color 0-2, depth 3, flow 4-5, reactive 6."""
    rc, dp, fl, re = stacked
    return torch.cat([rc, dp[:, None], fl, re[:, None]], 1)


def forward(net, stacked, dh: int, dw: int):
    """(B, 3, dh, dw): the bilinear upscale of each pair's colour plus the
    net's residual, one batched forward of (B, 7, dh, dw)."""
    x = net_input(stacked)
    b, c, h, w = x.shape
    x = filters.bilinear_resize(x.reshape(b * c, h, w), dh, dw)
    x = x.reshape(b, c, dh, dw)
    return x[:, :3] + net(x)


def loss_fn(net, stacked, targets, dh: int, dw: int):
    """MSE plus half the L1 of the image gradients' difference: the
    gradient term pushes the net toward edges instead of the blur that
    plain MSE rewards when the target carries other sampling noise."""
    preds = forward(net, stacked, dh, dw)
    mse = ((preds - targets) ** 2).mean()
    gx = lambda a: a[..., :, 1:] - a[..., :, :-1]
    gy = lambda a: a[..., 1:, :] - a[..., :-1, :]
    grad = ((gx(preds) - gx(targets)).abs().mean()
            + (gy(preds) - gy(targets)).abs().mean())
    return mse + 0.5 * grad


def fresh_net(seed: int = 0, device=None) -> lu.UpscaleNet:
    """A new f32 net: Flax's default init (lecun normal kernels, zero
    biases) drawn from a torch.Generator seeded with `seed`, and a zero
    residual head, so it starts as the bilinear upscale."""
    gen = torch.Generator().manual_seed(seed)
    net = lu.UpscaleNet()
    with torch.no_grad():
        for conv in net.convs:
            std = (1.0 / conv.weight[0].numel()) ** 0.5 / _TRUNC_STD
            torch.nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std,
                                        2.0 * std, generator=gen)
            conv.bias.zero_()
        net.convs[-1].weight.zero_()
    return net.to(device)


def cosine_decay(init_value: float, decay_steps: int, alpha: float = COSINE_ALPHA):
    """optax.cosine_decay_schedule(init_value, decay_steps, alpha): the
    learning rate of the update with index `count` (from 0)."""
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cos + alpha)
    return schedule


def make_optimizer(net, lr: float) -> torch.optim.Adam:
    """optax.adam's update (b1 0.9, b2 0.999, eps 1e-8); the step sets the
    learning rate from the schedule."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=BETAS, eps=EPS)


def apply_update(net, opt, lr: float) -> None:
    """The optax chain on the gradients in .grad: clip by global norm at
    CLIP_NORM, then one Adam step at learning rate lr."""
    torch.nn.utils.clip_grad_norm_(net.parameters(), CLIP_NORM)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def train_step(net, opt, lr: float, stacked, targets, dh: int, dw: int):
    """One optimiser step on the whole batch; returns the loss before it
    (a 0-d tensor on the batch's device: no host sync)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(net, stacked, targets, dh, dw)
    loss.backward()
    apply_update(net, opt, lr)
    return loss.detach()


@torch.no_grad()
def evaluate(net, pairs, dh: int, dw: int, device):
    """Mean SSIM of the net and of the bilinear upscale against the
    targets of `pairs`: (net, bilinear)."""
    from rt64tpu_torch.utils.ssim import ssim

    to_img = lambda a: np.clip(np.moveaxis(a, 0, -1), 0, 1)
    s_net, s_bil = [], []
    for inputs, target in pairs:
        stacked, _ = stack_batch([(inputs, target)], device)
        pred = forward(net, stacked, dh, dw)[0].cpu().numpy()
        bil = filters.bilinear_resize(stacked[0][0], dh, dw).cpu().numpy()
        s_net.append(ssim(to_img(pred), to_img(target), data_range=1.0))
        s_bil.append(ssim(to_img(bil), to_img(target), data_range=1.0))
    return float(np.mean(s_net)), float(np.mean(s_bil))


def corpus(pairs: int, device=None):
    """The JAX trainer's corpus: `pairs` each of the sample scene, the
    castle and the castle with GI, with its seeds: (batch, kinds)."""
    batch, kinds = [], []
    for kind, scene_kind, seed0, gi in (("sample", "sample", 7, 0),
                                        ("castle", "castle", 1007, 0),
                                        ("castle_gi", "castle", 2007, 1)):
        batch += render_pairs(pairs, scene_kind, seed0=seed0, gi=gi,
                              device=device)
        kinds += [kind] * pairs
    return batch, kinds


def hold_out(batch, kinds):
    """Pops the last pair of each kind from batch: the held-out pairs."""
    last_of_kind = {k: i for i, k in enumerate(kinds)}
    return [batch.pop(i) for i in sorted(last_of_kind.values(), reverse=True)]


def zero_unseen_inputs(net, stacked):
    """Zeroes Conv_0's weights of each input channel that is zero in every
    pair of `stacked` (flow, since the pairs are camera cuts): they get
    no gradient, so training would leave them at their random init, and
    the served net would respond to an input it never learned from (flow
    under a moving camera). Returns the channels zeroed (bool, (7,))."""
    unseen = (net_input(stacked) == 0).flatten(2).all(2).all(0)
    with torch.no_grad():
        net.convs[0].weight[:, unseen] = 0
    return unseen.cpu()


def fit(net, batch, steps: int, lr: float, device):
    """Trains `net` in place on the whole of `batch` for `steps` steps:
    zero_unseen_inputs, then train_step under the cosine schedule from
    lr. Returns each step's loss before it (0-d tensors on the device:
    no host sync in the loop)."""
    stacked, targets = stack_batch(batch, device)
    zero_unseen_inputs(net, stacked)
    dh, dw = targets.shape[-2:]
    opt = make_optimizer(net, lr)
    schedule = cosine_decay(lr, steps)
    return [train_step(net, opt, schedule(step), stacked, targets, dh, dw)
            for step in range(steps)]


def load_or_render(path, render):
    """(batch, kinds): the pair cache at `path` if it exists, else
    render(), cached to `path` when one is given."""
    if path and os.path.exists(path):
        print("loading cached pairs from", path)
        return load_pairs(path)
    batch, kinds = render()
    if path:
        save_pairs(path, batch, kinds)
        print("cached pairs to", path)
    return batch, kinds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--pairs", type=int, default=8,
                    help="pairs per scene kind (sample, castle, castle GI)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' is the only way off the card")
    ap.add_argument("--out", required=True,
                    help="weight file to write (the JAX package's layout)")
    ap.add_argument("--data", default=None,
                    help="pair cache (.npz): read if it exists, else written")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to train on the CPU")

    def render():
        print(f"rendering {args.pairs} sample + {args.pairs} castle + "
              f"{args.pairs} castle-GI pairs...")
        return corpus(args.pairs, device)

    batch, kinds = load_or_render(args.data, render)
    heldout = hold_out(batch, kinds)
    dh, dw = batch[0][1].shape[1:]

    net = fresh_net(0, device)
    losses = fit(net, batch, args.steps, args.lr, device)
    for step, loss in enumerate(losses):
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step}: loss {float(loss):.6f}")

    s_net, s_bil = evaluate(net, heldout, dh, dw, device)
    print(f"held-out SSIM vs native 2x: net {s_net:.4f} (bilinear {s_bil:.4f})")
    s_old, _ = evaluate(lu.get_net(device), heldout, dh, dw, device)
    print(f"shipped weights on the same held-out pairs: {s_old:.4f} "
          f"({'retrain wins' if s_net > s_old else 'shipped wins'})")
    lu.save_params(args.out, net)
    print("saved", args.out)


if __name__ == "__main__":
    main()
