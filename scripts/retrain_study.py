#!/usr/bin/env python3
"""Does the learned (DLSS) slot's net, retrained on the planes serving
feeds it, beat the shipped weights and the bilinear upscale?

Two steps, each one JSON line on stdout (and in --out/<step>.json):

    python3 scripts/retrain_study.py train --pairs 8 --steps 400 \
        --data build/upscaler_pairs.npz --heldout build/retrain_fresh.npz \
        --moving build/retrain_moving.npz --out build/retrain8
    python3 scripts/retrain_study.py bench5 build/retrain8/seed0.npz

train: the trainer's corpus (train_upscaler.corpus, cached in --data
through train_upscaler.load_or_render; the trainer's own run writes the
same cache) minus its held-out pair of each kind; one net trained from
fresh_net(seed) for each seed by train_upscaler.fit, the trainer's
protocol. Two more held-out sets of --fresh pairs of each kind, from
camera seeds the corpus does not use (FRESH_SEEDS): camera cuts, as the
corpus is drawn (cached in --heldout), and moving pairs, drawn with the
camera turned by MOVING_TURN_DEG from the frame before and reprojection
on, as serving draws a moving camera (cached in --moving). Reported: ms a
step, render seconds, each set's largest flow magnitude (px), and the
mean SSIM (train_upscaler.evaluate) on each held-out set of each seed's
net, of each --candidate file, of the shipped weights and of bilinear;
and whether the ship rule holds for the retrain's mean: on the fresh
cuts it beats both the shipped weights and bilinear by more than the
spread over the seeds, and on the moving pairs it falls below neither.

bench5: bench config 5's DLSS frame after BENCH5_FRAMES draws against
its native 3840x2160 reference (bench.native_banded, 4 bands of rows,
the same frames, drawn once), as chip_smoke.py's bench5_fidelity phase
measures it, once with the shipped weights and once with each file
given (learned_upscaler.PARAMS_PATH pointed at it, the net cache
cleared).

Runs on the CUDA card; --device cpu rehearses train at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rt64tpu_torch import bench  # noqa: E402
from rt64tpu_torch.models import learned_upscaler as lu  # noqa: E402
from rt64tpu_torch.models import train_upscaler as tu  # noqa: E402
from rt64tpu_torch.ops import math3d  # noqa: E402

# (kind, scene, camera seed, gi) of the held-out pairs: the corpus draws
# from seeds 7, 1007 and 2007.
FRESH_SEEDS = (("sample", "sample", 9007, 0), ("castle", "castle", 10007, 0),
               ("castle_gi", "castle", 11007, 1))
# The moving pairs' turn (degrees of pitch and yaw in view space) from
# the frame before: 5-12 px of flow at 96x128, as 50-120 px at 1280 wide.
MOVING_TURN_DEG = (3.0, 4.0)
BENCH5_FRAMES = 4
LR = 1e-3  # the trainer's default


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def report(out_dir, step, row):
    row = dict(step=step, card=bench.card() if torch.cuda.is_available()
               else None, **row)
    line = json.dumps(row)
    print(line, flush=True)
    if out_dir:
        with open(os.path.join(out_dir, f"{step}.json"), "w") as f:
            f.write(line + "\n")


def timed_pairs(path, render):
    """(batch, kinds, render seconds, or None when read from the cache)."""
    cached = bool(path) and os.path.exists(path)
    t0 = time.perf_counter()
    batch, kinds = tu.load_or_render(path, render)
    return batch, kinds, None if cached else time.perf_counter() - t0


def moving_pairs(n, scene, seed0, gi, device):
    """render_pairs' cameras, each drawn after the same camera turned back
    by MOVING_TURN_DEG (a cut), with reprojection on."""
    views = tu.scene_views(scene, gi=gi, device=device)
    back = -np.radians(MOVING_TURN_DEG)
    pairs = []
    for vm, fov in tu.camera_draws(n, scene, seed0):
        for dev, view in views.values():
            view.set_perspective(math3d.turn_view(vm, *back), fov, 0.1, 1000.0,
                                 False)
            dev.draw()
            view.set_perspective(vm, fov, 0.1, 1000.0, True)
            dev.draw()
        pairs.append((tu.frame_inputs(views["lo"][1]),
                      tu.frame_inputs(views["hi"][1])["rt_color"]))
    return pairs


def held_out(n, device, draw):
    batch, kinds = [], []
    for kind, scene, seed0, gi in FRESH_SEEDS:
        batch += draw(n, scene, seed0=seed0, gi=gi, device=device)
        kinds += [kind] * n
    return batch, kinds


def scores(net, sets, dh, dw, device):
    return {name: tu.evaluate(net, pairs, dh, dw, device)[0]
            for name, pairs in sets.items()}


def step_train(args, device):
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    batch, kinds, corpus_s = timed_pairs(
        args.data, lambda: tu.corpus(args.pairs, device))
    own = tu.hold_out(batch, kinds)
    fresh, _, fresh_s = timed_pairs(
        args.heldout, lambda: held_out(args.fresh, device, tu.render_pairs))
    moving, _, moving_s = timed_pairs(
        args.moving, lambda: held_out(args.fresh, device, moving_pairs))
    dh, dw = batch[0][1].shape[1:]
    sets = {"fresh": fresh, "moving": moving, "own": own}
    bilinear = {name: tu.evaluate(lu.get_net(device), pairs, dh, dw, device)[1]
                for name, pairs in sets.items()}
    shipped = scores(lu.get_net(device), sets, dh, dw, device)
    runs = []
    for seed in range(args.seeds):
        net = tu.fresh_net(seed, device)
        sync(device)
        t0 = time.perf_counter()
        losses = tu.fit(net, batch, args.steps, LR, device)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3 / args.steps
        runs.append(dict(seed=seed, ms_per_step=ms, loss_first=float(losses[0]),
                         loss_last=float(losses[-1]),
                         **scores(net, sets, dh, dw, device)))
        if args.out:
            lu.save_params(os.path.join(args.out, f"seed{seed}.npz"), net)
    row = dict(device=str(device), pairs_per_kind=args.pairs,
               train_pairs=len(batch), steps=args.steps, lr=LR,
               heldout_pairs={name: len(p) for name, p in sets.items()},
               moving_turn_deg=MOVING_TURN_DEG, corpus_render_s=corpus_s,
               fresh_render_s=fresh_s, moving_render_s=moving_s,
               flow_abs_max={name: max(float(abs(i["flow"]).max())
                                       for i, _ in pairs)
                             for name, pairs in (("train", batch), *sets.items())},
               bilinear=bilinear, shipped=shipped, runs=runs)
    for name in sets:
        got = [r[name] for r in runs]
        row[f"retrain_{name}_mean"] = statistics.fmean(got)
        row[f"retrain_{name}_spread"] = max(got) - min(got)
    row["candidates"] = []
    for path in args.candidate:
        net = lu.set_params(lu.UpscaleNet(), lu.load_params(path))
        row["candidates"].append(dict(
            path=path, **scores(net.to(device), sets, dh, dw, device)))
    best = {name: max(shipped[name], bilinear[name]) for name in sets}
    row["rule_holds_for_the_mean"] = (
        row["retrain_fresh_mean"] - best["fresh"] > row["retrain_fresh_spread"]
        and row["retrain_moving_mean"] >= best["moving"])
    report(args.out, "train", row)


def step_bench5(args, device):
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    from rt64tpu_torch.utils.ssim import ssim

    rung = bench.CONFIGS[5]
    t0 = time.perf_counter()
    native, drops = bench.native_banded(*rung[:6], bench.NATIVE_BANDS,
                                        BENCH5_FRAMES)
    native_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    shipped_path = lu.PARAMS_PATH
    rows = []
    try:
        for path in (shipped_path, *args.files):
            lu.PARAMS_PATH = path
            lu._net_on.cache_clear()
            t0 = time.perf_counter()
            prod = bench.final_image(*rung, BENCH5_FRAMES)
            rows.append(dict(path=path, ssim=ssim(prod, native),
                             dlss_s=time.perf_counter() - t0))
            del prod
            torch.cuda.empty_cache()
    finally:
        lu.PARAMS_PATH = shipped_path
        lu._net_on.cache_clear()
    report(args.out, "bench5", dict(config=5, frames=BENCH5_FRAMES,
                                    native_bands=bench.NATIVE_BANDS,
                                    native_s=native_s, native_dropped=drops,
                                    files=rows))


def main(argv=None):
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda")
    common.add_argument("--out", default=None, help="directory for the results")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="step", required=True)
    t = sub.add_parser("train", parents=[common])
    t.add_argument("--pairs", type=int, default=8)
    t.add_argument("--steps", type=int, default=400)
    t.add_argument("--seeds", type=int, default=3)
    t.add_argument("--fresh", type=int, default=8)
    t.add_argument("--data", default=None)
    t.add_argument("--heldout", default=None)
    t.add_argument("--moving", default=None)
    t.add_argument("--candidate", action="append", default=[])
    b = sub.add_parser("bench5", parents=[common])
    b.add_argument("files", nargs="*")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; train runs on the CPU with --device cpu")
    if args.step == "bench5" and device.type != "cuda":
        raise SystemExit("bench5 needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (step_train if args.step == "train" else step_bench5)(args, device)


if __name__ == "__main__":
    main()
