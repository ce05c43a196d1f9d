#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rt64tpu_torch) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero before the
result line):
  1. card: nvidia-smi's name and power limit (verbatim), TF32 off;
  2. build: nvcc builds every source under csrc/ (packet_tracer.cu: K1/K2,
     mt_tracer.cu: K3/K4, both over the walk of packet_walk.cuh;
     alpha_sweep.cu: the alpha slots' K-hit sweep), build seconds;
  3. K1 (closest hit) against its plain twin (run once) on the castle 640x480
     frame's own primary-ray batch: tri agreement, hit/miss flips,
     t relative and u/v absolute error p99, bias equality, kernel/plain
     ms, and the bound from the pairs that reached each stage of the
     pair test in this launch;
  4. K2 (occlusion) the same way on the frame's batched shadow launch;
     for both (and for every K1-K4 launch below) also the work items,
     the CTAs of the persistent grid, the cycles of the longest item and
     block, and order_independent: two production launches, and one with
     the item table reversed, give equal outputs bit for bit;
  4b. the alpha sweep's kernel against its plain twin (run on the card
     in slices) on every sweep of that frame: triangle ids exactly equal,
     t, u, v and bias bit-equal; per launch kernel ms (median of 25),
     plain ms, and the bound from its live rays and list entries;
  4b'. the alpha cull's kernel against its plain twin (run on the card)
     on every cull of that frame: the masks bit-equal, one launch a cull;
     per cull kernel ms (median of 25), plain ms, and the bound from the
     (live bundle, live box) pairs the cull needs (each bundle's boxes up
     to its first hit) and its bytes;
  4c. the hit shader's kernel against its plain version (run on the
     card) on every shade_hits call of that frame: instance and rows_t
     equal, every float plane bit-equal; per call the width and live
     lanes, kernel ms (median of 25), plain ms, the bytes bound, and one
     launch a call (hit_shade_launches);
  5. main path: 10 castle frames through Device.draw(), with the
     launch counters set to 0 just before and read just after (K1, K2,
     the alpha sweep and the hit shader at least once a frame);
  6. sample scene 320x240 rendered on the card and on the CPU, SSIM;
  6b. K1 and K2 the same way on the regrouped bounce launches of a
     castle GI 1280x720 frame (the ray mix of bench config 3: incoherent
     rays, long visit lists);
  6c. reflections: the same castle GI 1280x720 frame with two reflection
     bounces (bench config 4 at native size): 10 frames through
     Device.draw() with the launch counts set to 0 just before and read
     just after (K1 exactly 2 launches a frame and one a reflection
     bounce with a live mirror ray, read from the frame record), the
     framebuffer held against the frame drawn without reflections (it
     must differ where a reflection was seeded and equal it elsewhere),
     and K1 against its twin on the reflection launches of a settled
     draw (mirror rays, unregrouped, on the live rays' bundles alone; a
     second bounce with no live ray is not launched);
  6d. raster layers: the castle-raster frame (6c's frame with the
     castle's sky plane removed, a raster-background skybox and a HUD of
     12 textured quads): against two draws of it without the HUD, every
     pixel outside the HUD triangles (a float64 edge test of the packed
     rows) is bit-equal and 90 % of the covered ones change; against two
     draws without any raster layer, 99 % of the pixels black there
     (primary misses) are not black with the skybox; 10 frames through
     Device.draw() (K1/K2 launch counts, frame ms, peak memory), all
     launches of one profiled frame, device ms and launches of each
     raster pass and of one environment-map gather; then every debug
     view of one such frame's outputs on the card against its CPU copy,
     and one draw of the depth view with the HUD drawn over it;
  7. K3 (closest hit, 128-triangle clusters) against its plain twin on
     the primary launch of a large-castle 1280x720 GI frame, K1 on the
     same rays and scene for comparison, and K3 against its twin on the
     frame's regrouped bounce launch (incoherent rays, long visit
     lists: the frame's dearest K3 launch);
  8. K4 (occlusion) the same way on that frame's largest shadow launch,
     with K2 on the same rays, and on its bounce-shadow launch;
  8b. K3 against its twin on the first reflection launch of one more
     draw of that scene, with two reflection bounces;
  9. large-scene GI path: 10 frames of the large castle (32,768-triangle
     bucket, beyond the size switch) at 1280x720 with di 1, gi 1 and the
     denoiser (which turns GI reprojection on) through Device.draw();
     K3 and K4 must launch, K1 and K2 must not, history must be read;
 10. castle 160x120 with GI (K1/K2 path, regrouped bounce rays), two
     frames on the card and on the CPU, SSIM;
 11. card against CPU, SSIM: the castle 160x120 with GI, the denoiser
     and two reflection bounces (two frames); the glass sample scene
     160x120 with its glass made translucent (refraction, its shadow
     rays through K2) and two reflection bounces; the mip-LOD floor
     128x96; and on the card the floor's dealiasing (band std with the
     flag under 0.35 of without, band means within 0.02);
 12. the golden frame (the sample scene 160x120 with a HUD triangle, two
     draws) on the card at SSIM >= 0.98 against
     tests/golden/sample_160x120.png, read by the port's PNG decoder;
     and the sample scene 160x120 without its sky plane, with the raster
     skybox and HUD, gi 1, two draws, card against CPU at SSIM >= 0.99;
 13. upscaled: bench configs 2, 3 and 4 exactly as bench.py builds them
     (FSR auto; render 512x368, 960x552, 960x552) through Device.draw():
     a settling draw, one draw with the temporal history dropped, which
     must equal the bilinear upscale of its render (1e-5), then 5, 5 and
     10 frames with the launch counts set to 0 just before and read just
     after, and one profiled frame (device ms, launches); gates: render
     and image sizes, K1/K2 at least once a frame, no K3/K4, at least 3
     jitter values, a present that is not black;
 14. upscalers_small: the sample scene at display 160x120, three draws
     each with FSR auto, XeSS auto and DLSS performance, and one FSR draw
     with RCAS and motion blur over a moving sphere, card against CPU at
     SSIM >= 0.99 per frame; the learned residual card vs CPU;
 15. streamed: bench.py's measure_streamed loop on bench config 4 as
     written (instance 1 turned by 0.03 f radians, the camera pushed,
     Device.draw()): settling draws, then 10 frames full sync and 10
     pipelined (the present ring of depth 2, after 2 priming draws), the
     launch counts set to 0 just before each and read just after; per
     mode the draw ms median and range, device ms, launches and idle
     share of 3 profiled frames, peak memory, and the host-synchronising
     calls of 5 frames (torch's sync-debug mode); gates: every pipelined
     present is byte for byte the frame drawn two draws before, the ring
     saves at least 2 syncs a frame, holds at most its depth after a
     draw, and presents are not black;
 16. midframe: interpolated_midframe of the sample scene 160x120 with FSR
     auto (render 128x96), card against CPU at SSIM >= 0.99; on bench
     config 3 as written its ms (CUDA events), and a yaw between two
     draws that moves the picture s px moves the midframe s/2 +- 1 px
     (the flow scaled from render to display pixels);
 17. banded: castle GI 1280x720 (denoiser off, then on) drawn 3 frames
     whole and in 2 bands (360 rows, tiled) and 4 (180 rows, untiled)
     from zeros: mean abs < 1e-6, max abs < 1e-4 (with the denoiser, away
     from the rows within gi_filter_passes of a band edge, whose max is
     printed), instance planes equal, no alpha hits dropped; ms and peak
     per band; with the denoiser also a moving camera in 2 and 4 bands:
     the view turned by MOVE_TURN_DEG (pitch, yaw) before each of 3
     frames, so prev_view_proj differs from view_proj, drawn whole and
     in bands with the history carried on each side: the same bounds on
     the image and on every row of the flow, depth and history planes,
     instance planes equal, the flow's largest magnitude at least
     MOVE_FLOW_MIN px (printed, with K1/K2's launches in each run); then
     bench config 5's fidelity as bench.py's measure_ssim
     computes it: the DLSS performance frame after 8 draws against the
     native 3840x2160 frame drawn in 4 bands of 540 rows (6 if 4 do not
     fit, and the failed allocation is printed), 8 frames with the
     history concatenated across the bands; SSIM, peaks, band ms; and
     4b's, 4b''s and 4c's checks on every alpha sweep, every alpha cull
     and every shade_hits call of the last DLSS draw (1920x1080, the 4K
     cell's frame);
 18. inspector: castle 640x480 with one light just ahead of the camera
     and one far behind the castle: after "gizmos on" the rings are
     drawn, pixels in the open take the ring's colour and occluded ones
     on even checkerboard squares stay; "dump" writes a PNG that reads
     back as the framebuffer; an edit and "camera rotate" change the next
     draw;
 19. abi: librt64tpu_torch.so and both sample hosts built with g++
     (rt64tpu_torch/abi/build.py); each host run in a subprocess on the
     card at 320x240 (exit 0, a PPM; sample_host picks the sphere,
     sample_host_dl binds through RT64TPU_LIBRARY); each PPM against its
     calls replayed in Python through the port's bridge with every draw
     made through the library's RT64_DrawDevice, SSIM >= 0.99 (max abs
     difference and byte equality printed), K1/K2 launched in those
     draws, RT64_GetLastError empty; the ms of each draw through the ABI
     and through Device.draw(); the SSIM against the JAX package's
     checked-in sample_host.ppm (printed only);
 20. dds: a BC1, a BC2 and a BC3 texture of random blocks (a seed, numpy)
     decoded on the host, on the sample scene's sphere at 160x120, two
     draws card against CPU at SSIM >= 0.99;
 21. train: the upscaler trainer's render_pairs at 96x128 -> 192x256,
     2 pairs each of the sample, the castle and the castle with GI on the
     card (K1/K2 launches counted), 50 steps of a fresh net through
     train_upscaler.fit: the loss finite and lower at step 49 than at
     step 0, the step-0 loss card against CPU within 1e-5, Conv_0's flow
     weights zero; ms per step, held-out SSIM of the net, the
     bilinear upscale and the shipped weights; weights written under
     build/;
 22. bench: python3 -m rt64tpu_torch.bench --config 1 (8 frames, 2 reps):
     its JSON line parses with bench.py's keys and the card's name;
then the kernel table line and the result line. Phases 15 and 17 drive
the loops of rt64tpu_torch.bench (StreamedLoop, native_banded).

It imports torch, numpy and rt64tpu_torch only.
"""

import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# FP32 work of one (ray, triangle) pair, counted as the function needs
# it. The pair test returns early after every stage, so a stage is
# charged only to the pairs that reached it: the kernels' counting
# instantiations report, per launch, the pairs that live, unblocked rays
# tested and the pairs that passed stages 1 to 4 (csrc/work_stats.cuh).
# FLOPS_<kernel>[k] is the cost of the stage that a pair reaches by
# passing k stages. The kernels test only the rays that enter a
# cluster's box, so their counts, and with them their bounds, are lower
# than those of the same launches before that cull.
# K1 (Woop): the keep test r_z = W[2] d (3 products, 2 sums); then
# s_z (6) and t = -s_z / r_z (1); then, t in range, s_x (6), r_x (5),
# u = s_x + t r_x (2); then, u >= 0, s_y (6), r_y (5), v (2), u + v (1);
# a hit pays the key t - bias (1).
FLOPS_K1 = (5, 7, 13, 14, 1)
# K2 (Woop, division-free): r_z (5); then s_z (6), q, p (2), t_min q,
# t_max q (2); then, t in range, s_x r_x s_y r_y (22), uq, vq (6),
# uq + vq (1). A hit pays nothing more.
FLOPS_K2 = (5, 10, 29, 0, 0)
# K3/K4 (Moller-Trumbore): a pair of a live, unblocked ray and an active
# triangle pays p = d x e2 (9) and det = e1 . p (5); then, the
# determinant passed, 1 / det (1), o - v0 (3), u (6); then, u >= 0,
# q = tvec x e1 (9), v (6), u + v (1); then, v and u + v passed, t (6);
# a hit pays, in K3, the key t - bias (1).
FLOPS_K3 = (14, 10, 16, 6, 1)
FLOPS_K4 = (14, 10, 16, 6, 0)
# The alpha sweep (csrc/alpha_sweep.cu) tests every pair of a live ray
# (t_max >= t_min) and a live list entry (id >= 0). Every such pair pays
# at least K3's first stage, p = d x e2 and det = e1 . p (14); what a
# pair pays past it depends on the data and is not counted, so the bound
# is a floor. Bytes, each once: a ray's origin, direction and interval
# (32), a hit slot's key, id, u, v and bias (24), a list entry's id,
# corners, bias and cull flag (49).
FLOPS_SWEEP_PAIR = FLOPS_K3[0]
SWEEP_RAY_BYTES, SWEEP_SLOT_BYTES, SWEEP_ENTRY_BYTES = 32, 24, 49
# Rays a call of the plain twin takes on the card: its (rays x 256)
# planes at the 4K frame's 4,147,200 shadow lanes would not fit beside
# the frame. A row's result does not depend on the other rows.
SWEEP_TWIN_SLICE = 1 << 18
# The alpha cull (csrc/alpha_cull.cu) walks a live bundle's live boxes in
# list order up to its first hit. A pair it tests pays, per axis, 2
# differences, 4 products and 8 minima or maxima (42), then the widening
# of the interval, 2 products and 4 sums (6); the comparisons are not
# counted. The pairs are those these inputs need: each live bundle's live
# boxes up to and with its first hit, all of them where it hits none.
# Bytes, each once: a lane's origin, direction and interval (32) and its
# mask byte (1), a box (24).
FLOPS_CULL_PAIR = 48
CULL_LANE_BYTES, CULL_BOX_BYTES = 33, 24
# The hit shader (csrc/hit_shade.cu) is bounded by bytes. A floor, each
# byte once: a lane's inputs (its id, u, v, noise and direction; with the
# mip level its t and two differentials) and its outputs (rows_t, color,
# normal, specular, flow, instance; the shadow variant writes color and
# one zero plane), and the row of each distinct triangle hit. The quad
# fetches are left out.
HIT_ROW_BYTES = 108 * 4  # rows.TROW floats
HIT_LANE_IN_BYTES, HIT_MIP_IN_BYTES = 4 + 12 + 12, 28
HIT_LANE_OUT_BYTES = HIT_ROW_BYTES + 16 + 36 + 4
HIT_SHADOW_OUT_BYTES = HIT_ROW_BYTES + 16 + 12 + 4
CASTLE_W, CASTLE_H = 640, 480
MAIN_FRAMES = 10
GI_W, GI_H = 1280, 720
# Bench config 4: the castle GI frame with two reflection bounces.
REFL_BOUNCES = 2
REFL_FRAMES = 10
# The castle drawn with and without reflections, after the same draws:
# a pixel that seeds no reflection may differ by at most this much per
# RGB8 channel (the GI noise of one draw, should the boost ladder climb
# once more with reflections; measured 0 when it does not), and at least
# half the pixels that seed one must differ by more than
# REFL_CHANGED_MIN.
REFL_ELSEWHERE_TOL = 8
REFL_CHANGED_MIN = 2
LARGE_W, LARGE_H = 1280, 720
LARGE_TERRAIN_N = 128
LARGE_FRAMES = 10


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed(fn):
    """(fn(), its device time in ms): one run between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, reps, warmup=2):
    """Median device time of fn() over `reps` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


WRAPPERS = ("trace_opaque_blocks", "trace_shadow_blocks",
            "trace_opaque_mt_blocks", "trace_shadow_mt_blocks",
            "prepare_opaque", "prepare_shadow", "alpha_sweep", "hit_shade",
            "alpha_cull")


def capture_launches(draw):
    """Run one draw with the kernel wrappers and the packet preps wrapped
    by recorders; returns {name: [(args, kwargs), ...]} in call order."""
    from rt64tpu_torch.ops import tracer_cuda as tc

    seen = {name: [] for name in WRAPPERS}
    originals = {name: getattr(tc, name) for name in WRAPPERS}

    def recorder(name):
        def rec(*args, **kw):
            seen[name].append((args, kw))
            return originals[name](*args, **kw)
        return rec

    for name in WRAPPERS:
        setattr(tc, name, recorder(name))
    try:
        draw()
    finally:
        for name in WRAPPERS:
            setattr(tc, name, originals[name])
    return seen


def counted_work(stats, flops_by_stage):
    """Sum a counting launch's per-block rows and charge each stage to
    the pairs that reached it (the tested pairs, then those past stages
    1 to 4): the fields of the phase's line. K3/K4 also fill the cycle
    columns: the cycles a block's items held a CTA, and its longest item."""
    from rt64tpu_torch.ops import tracer_cuda as tc

    walked, tested, *passed = (
        int(x) for x in stats[:, :1 + tc.STAT_STAGES].sum(dim=0))
    flops = sum(f * n for f, n in zip(flops_by_stage, [tested] + passed))
    work = dict(visits_walked=walked,
                visits_walked_longest_block=int(stats[:, 0].max()),
                pairs_tested=tested, pairs_past_stage=passed,
                flops_per_pair_by_stage=list(flops_by_stage), flops=flops)
    if int(stats[:, tc.STAT_CYCLES].max()) > 0:
        work.update(
            cycles_all_items=int(stats[:, tc.STAT_CYCLES].sum()),
            cycles_longest_block=int(stats[:, tc.STAT_CYCLES].max()),
            cycles_longest_item=int(stats[:, tc.STAT_ITEM_CYCLES].max()))
    return work


def work_item_fields(tag, wrapper, args, kw, shadow):
    """The launch's work items and grid, and whether its outputs depend
    on the order the items ran in (they must not): two production
    launches, and one with the item table reversed, must give equal
    outputs bit for bit."""
    import torch
    from rt64tpu_torch.ops import tracer_cuda as tc

    counts, n_cols = args[3], args[2].shape[1]
    items, n_items = tc.work_items_on_card(counts, n_cols)
    twin_items, twin_n = tc.build_work_items(counts, n_cols)
    n = int(n_items)
    check(n == int(twin_n) and torch.equal(items[:n], twin_items[:n]),
          f"{tag}: the card's item table differs from build_work_items'")
    backwards = items.clone()
    backwards[:n] = items[:n].flip(0)
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
    first = as_tuple(wrapper(*args, **kw))
    again = as_tuple(wrapper(*args, **kw))
    turned = as_tuple(wrapper(*args, items=(backwards, n_items), **kw))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(first, again, turned))
    woop = args[1].shape[2] == tc.K_CS
    grid = tc.walk_grid(woop, shadow)
    return dict(work_items=n, slice_visits=tc.SLICE_VISITS,
                ctas_launched=min(grid, items.shape[0]),
                ctas_with_work=min(grid, n), order_independent=same)


def largest(calls):
    """The recorded call with the most rays (its first argument is
    rays8 for a kernel wrapper, origins for a prep)."""
    return max(calls, key=lambda c: c[0][0].shape[1])


def closest_hit_phase(tag, call, wrapper, twin, flops_by_stage):
    """Hold a closest-hit kernel (K1 or K3) against its plain twin on one
    recorded launch (with the keyword arguments the frame gave it), time
    both (the twin runs once, and that run is its time), and bound it by
    the counted work."""
    import torch
    from rt64tpu_torch.ops import tracer_cuda as tc
    from rt64tpu_torch.utils.kernel_times import batched_ms

    (rays8, clusters, visits, counts, entries, cull), kw = call
    n = rays8.shape[1]
    args = (rays8, clusters, visits, counts, entries, cull)
    t_k, tri_k, u_k, v_k, b_k = wrapper(*args, **kw)
    (t_p, tri_p, u_p, v_p, b_p), plain_ms = timed(lambda: twin(*args))
    # The counting instantiation: the work this run's data needs.
    stats = torch.empty((counts.shape[0], tc.STATS_COLS), dtype=torch.int64,
                        device=rays8.device)
    t_s, tri_s, u_s, v_s, b_s = wrapper(*args, stats=stats, **kw)
    torch.cuda.synchronize()
    agree = (tri_k == tri_p).float().mean().item()
    flips = ((tri_k >= 0) != (tri_p >= 0)).float().mean().item()
    same = (tri_k == tri_p) & (tri_k >= 0)
    hits = int(same.sum())
    if not hits:
        # A launch with no hit at all (a reflection bounce with nothing
        # left to mirror): every output must equal the twin's "no hit"
        # (tri -1, t = t_max + 1, u = v = bias = 0) on every ray.
        check(bool((tri_k == -1).all() and (tri_p == -1).all()),
              f"{tag} and its plain twin share no hit")
        same = torch.ones_like(same)
    abs_err = lambda a, b: (a[same] - b[same]).abs().double()
    rel = abs_err(t_k, t_p) / t_p[same].abs().clamp(min=1e-6)
    rel_p99 = quantile(rel, 0.99)
    uv_p99 = max(quantile(abs_err(u_k, u_p), 0.99),
                 quantile(abs_err(v_k, v_p), 0.99))
    errs = {k: abs_err(a, b).max().item() for k, a, b in (
        ("t", t_k, t_p), ("u", u_k, u_p), ("v", v_k, v_p), ("bias", b_k, b_p))}
    stats_same = all(torch.equal(a, b) for a, b in (
        (t_s, t_k), (tri_s, tri_k), (u_s, u_k), (v_s, v_k), (b_s, b_k)))
    del t_p, tri_p, u_p, v_p, b_p, t_s, tri_s, u_s, v_s, b_s
    ms = time_ms(lambda: wrapper(*args, **kw), reps=25)
    ms_batched = batched_ms(lambda: wrapper(*args, **kw))
    work = counted_work(stats, flops_by_stage)
    work.update(work_item_fields(tag, wrapper, args, kw, shadow=False))
    n_bytes = sum(a.numel() * a.element_size()
                  for a in (rays8, clusters, visits, counts, entries))
    n_bytes += 5 * 4 * n
    bms, by = bound_ms(n_bytes, work["flops"])
    row = dict(phase=tag, rays=n, live_rays=int((rays8[7] >= rays8[6]).sum()),
               hits=hits, blocks=counts.shape[0],
               clusters=clusters.shape[0] - 1,
               cluster_triangles=clusters.shape[2],
               tri_agreement=agree, hit_miss_flips=flips,
               t_rel_err_p99=rel_p99, uv_abs_err_p99=uv_p99,
               max_abs_err=max(errs.values()), max_abs_err_by_output=errs,
               counting_launch_same=stats_same,
               visits_listed=int(counts.sum()), **work,
               bytes=n_bytes, ms=ms, ms_batched=ms_batched,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    emit(row)
    check(agree >= 0.999, f"{tag} tri agreement {agree} < 0.999")
    check(flips < 0.001, f"{tag} hit/miss flips {flips} >= 0.001")
    check(rel_p99 < 1e-3, f"{tag} t rel err p99 {rel_p99} >= 1e-3")
    check(uv_p99 < 1e-3, f"{tag} u/v abs err p99 {uv_p99} >= 1e-3")
    check(errs["bias"] == 0.0, f"{tag} bias differs by {errs['bias']}")
    check(stats_same, f"{tag}'s counting launch gave another result")
    check(row.get("order_independent", True),
          f"{tag}'s outputs depend on the order of its work items")
    return row


def quantile(x, q):
    """torch.quantile takes at most 2^24 elements: sort instead."""
    x = x.flatten().sort().values
    return x[min(int(q * x.numel()), x.numel() - 1)].item()


def occlusion_phase(tag, call, wrapper, twin, flops_by_stage):
    """Hold an occlusion kernel (K2 or K4) against its plain twin on one
    recorded launch, time both (the twin once), and bound it by the
    counted work."""
    import torch
    from rt64tpu_torch.ops import tracer_cuda as tc
    from rt64tpu_torch.utils.kernel_times import batched_ms

    (rays8, clusters, visits, counts, entries), kw = call
    n = rays8.shape[1]
    args = (rays8, clusters, visits, counts, entries)
    bl_k = wrapper(*args, **kw)
    bl_p, plain_ms = timed(lambda: twin(*args))
    stats = torch.empty((counts.shape[0], tc.STATS_COLS), dtype=torch.int64,
                        device=rays8.device)
    bl_s = wrapper(*args, stats=stats, **kw)
    torch.cuda.synchronize()
    agree = (bl_k == bl_p).float().mean().item()
    max_abs = (bl_k - bl_p).abs().max().item()
    stats_same = torch.equal(bl_s, bl_k)
    ms = time_ms(lambda: wrapper(*args, **kw), reps=25)
    ms_batched = batched_ms(lambda: wrapper(*args, **kw))
    work = counted_work(stats, flops_by_stage)
    work.update(work_item_fields(tag, wrapper, args, kw, shadow=True))
    n_bytes = sum(a.numel() * a.element_size() for a in args)
    n_bytes += 4 * n
    bms, by = bound_ms(n_bytes, work["flops"])
    live = int((rays8[7] >= rays8[6]).sum())
    row = dict(phase=tag, rays=n, live_rays=live, blocks=counts.shape[0],
               clusters=clusters.shape[0] - 1,
               cluster_triangles=clusters.shape[2],
               blocked_agreement=agree, blocked_k=int(bl_k.sum()),
               blocked_plain=int(bl_p.sum()), counting_launch_same=stats_same,
               visits_listed=int(counts.sum()), **work,
               bytes=n_bytes, ms=ms, ms_batched=ms_batched,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               max_abs_err=max_abs)
    emit(row)
    check(agree >= 0.999, f"{tag} blocked agreement {agree} < 0.999")
    check(stats_same, f"{tag}'s counting launch gave another result")
    check(row.get("order_independent", True),
          f"{tag}'s outputs depend on the order of its work items")
    return row


def phase_k1(tag, call):
    from rt64tpu_torch.ops import tracer_cuda as tc

    return closest_hit_phase(tag, call, tc.trace_opaque_blocks,
                             tc.trace_opaque_plain, FLOPS_K1)


def phase_k2(tag, call):
    from rt64tpu_torch.ops import tracer_cuda as tc

    return occlusion_phase(tag, call, tc.trace_shadow_blocks,
                           tc.trace_shadow_plain, FLOPS_K2)


def alpha_sweep_phase(tag, calls):
    """alpha_sweep_kernel against its plain twin, run on the card in
    slices of SWEEP_TWIN_SLICE rays, on every sweep one draw launched
    (recorded with the inputs the frame gave it): triangle ids exactly
    equal, t, u, v and bias bit-equal. Each launch timed (the kernel:
    median of 25, CUDA events; the twin once) and bounded from its
    inputs. One line a launch; returns the draw's row, with the sums
    over its launches as ms, plain_ms and bound_ms."""
    import torch
    from rt64tpu_torch.ops import tracer as ptr
    from rt64tpu_torch.ops import tracer_cuda as tc

    calls = [c for c in calls if c[0][0].shape[1] > 0]
    check(calls, f"{tag}: the draw launched no alpha sweep")
    bits = lambda a: a.view(torch.int32) if a.dtype == torch.float32 else a
    rows = []
    for i, (args, kw) in enumerate(calls):
        origins, dirs, t_min, t_max, scene, k, cull = args
        n = origins.shape[1]

        def twin():
            parts = [ptr._alpha_sweep_plain(
                origins[:, a:a + SWEEP_TWIN_SLICE],
                dirs[:, a:a + SWEEP_TWIN_SLICE], t_min[a:a + SWEEP_TWIN_SLICE],
                t_max[a:a + SWEEP_TWIN_SLICE], scene, k, cull)
                for a in range(0, n, SWEEP_TWIN_SLICE)]
            return [torch.cat([p[j] for p in parts]) for j in range(4)]

        got = tc.alpha_sweep(*args, **kw)
        want, plain_ms = timed(twin)
        names = ("t", "tri", "uv", "bias")
        equal = {m: torch.equal(bits(g), bits(w))
                 for m, g, w in zip(names, got, want)}
        errs = {m: float((g.double() - w.double()).abs().max())
                for m, g, w in zip(names, got, want) if m != "tri"}
        hits = int((want[1] >= 0).sum())
        del got, want
        ms = time_ms(lambda: tc.alpha_sweep(*args, **kw), reps=25)
        live = int((t_max >= t_min).sum())
        entries = int((scene.alpha_idx >= 0).sum())
        a_cap = scene.alpha_idx.shape[0]
        flops = live * entries * FLOPS_SWEEP_PAIR
        n_bytes = (n * (SWEEP_RAY_BYTES + k * SWEEP_SLOT_BYTES)
                   + a_cap * SWEEP_ENTRY_BYTES)
        bms, by = bound_ms(n_bytes, flops)
        row = dict(phase=tag, launch=i, rays=n, live_rays=live, k=k,
                   cull_backface=bool(cull), list_entries=a_cap,
                   live_entries=entries, hits=hits, bit_equal=equal,
                   max_abs_err=max(errs.values()), max_abs_err_by_output=errs,
                   bytes=n_bytes, flops=flops, ms=ms, plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by)
        emit(row)
        check(all(equal.values()),
              f"{tag} launch {i}: the kernel differs from its twin: {equal}")
        rows.append(row)
    dearest = max(rows, key=lambda r: r["bound_ms"])
    out = dict(phase=f"{tag}_draw", launches=len(rows),
               rays=[r["rays"] for r in rows],
               live_rays=[r["live_rays"] for r in rows],
               max_abs_err=max(r["max_abs_err"] for r in rows),
               ms=sum(r["ms"] for r in rows),
               plain_ms=sum(r["plain_ms"] for r in rows),
               bound_ms=sum(r["bound_ms"] for r in rows),
               bound_by=dearest["bound_by"])
    emit(out)
    return out


def cull_pairs(origins, dirs, t_min, t_max, lo, hi):
    """The (live bundle, live box) pairs the alpha cull needs on these
    inputs: each live bundle's live boxes in list order up to and with
    its first hit, all of them where it hits none (by the twin's hit
    plane)."""
    import torch
    from rt64tpu_torch.ops import tracer as ptr

    hulls = ptr.bundle_hulls(origins, dirs, t_min, t_max)
    hit, _ = ptr._slab_interval_hit(*hulls, lo, hi)
    hit = hit[:, torch.all(lo <= hi, dim=0)]
    live = hulls[0][0] <= hulls[1][0]
    if hit.shape[1] == 0:
        return 0
    first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1,
                        hit.shape[1])
    return int(first[live].sum())


def alpha_cull_phase(tag, calls):
    """alpha_cull_kernel against its plain twin, run on the card, on every
    cull one draw launched (recorded with the inputs the frame gave it):
    the masks bit-equal, one launch a cull. Each cull timed (the kernel:
    median of 25, CUDA events; the twin once) and bounded by the larger
    of its bytes and the FP32 work of the pairs it needs. One line a
    cull; returns the draw's row, with the sums over its culls as ms,
    plain_ms and bound_ms."""
    import torch
    from rt64tpu_torch.ops import tracer as ptr
    from rt64tpu_torch.ops import tracer_cuda as tc

    calls = [c for c in calls if c[0][0].shape[1] > 0]
    check(calls, f"{tag}: the draw launched no alpha cull")
    rows = []
    for i, (args, kw) in enumerate(calls):
        origins, dirs, t_min, t_max, lo, hi = args
        n, m = origins.shape[1], lo.shape[1]
        before = tc.launch_counts.alpha_cull_launches
        got = tc.alpha_cull(*args, **kw)
        launches = tc.launch_counts.alpha_cull_launches - before
        want, plain_ms = timed(lambda: ptr._slab_any_bundled_plain(*args))
        equal = torch.equal(got, want)
        marked = int(want.sum())
        del got, want
        pairs = cull_pairs(*args)
        torch.cuda.empty_cache()
        ms = time_ms(lambda: tc.alpha_cull(*args, **kw), reps=25)
        live = int((t_max >= t_min).sum())
        live_bundles = int((t_max >= t_min).view(-1, 8).any(dim=1).sum())
        live_boxes = int(torch.all(lo <= hi, dim=0).sum())
        flops = pairs * FLOPS_CULL_PAIR
        n_bytes = n * CULL_LANE_BYTES + m * CULL_BOX_BYTES
        bms, by = bound_ms(n_bytes, flops)
        row = dict(phase=tag, launch=i, lanes=n, live_lanes=live,
                   live_bundles=live_bundles, boxes=m, live_boxes=live_boxes,
                   marked_lanes=marked, pairs_needed=pairs,
                   pairs_all=live_bundles * live_boxes, bit_equal=equal,
                   alpha_cull_launches=launches, bytes=n_bytes, flops=flops,
                   ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   max_abs_err=0.0 if equal else None)
        emit(row)
        check(equal, f"{tag} launch {i}: the kernel's mask differs from its twin's")
        check(launches == 1, f"{tag} launch {i}: {launches} launches, not 1")
        rows.append(row)
    dearest = max(rows, key=lambda r: r["bound_ms"])
    out = dict(phase=f"{tag}_draw", launches=len(rows),
               lanes=[r["lanes"] for r in rows],
               live_lanes=[r["live_lanes"] for r in rows],
               pairs_needed=[r["pairs_needed"] for r in rows], max_abs_err=0.0,
               ms=sum(r["ms"] for r in rows),
               plain_ms=sum(r["plain_ms"] for r in rows),
               bound_ms=sum(r["bound_ms"] for r in rows),
               bound_by=dearest["bound_by"])
    emit(out)
    return out


def hit_shade_phase(tag, calls):
    """hit_shade_kernel against the plain version of shade_hits, run on
    the card, on every call one draw made (recorded with the inputs the
    frame gave it): instance and rows_t equal, color, normal, specular and
    flow bit-equal (NaN where both are NaN), one launch a call. Each call
    timed (the kernel: median of 25, CUDA events; the plain version once)
    and bounded by its bytes. One line a call; returns the draw's row,
    with the sums over its calls as ms, plain_ms and bound_ms."""
    import torch
    from rt64tpu_torch.ops import shading
    from rt64tpu_torch.ops import tracer_cuda as tc

    calls = [c for c in calls if c[0][3].shape[0] > 0]
    check(calls, f"{tag}: the draw shaded no hit")
    names = ("color", "normal", "specular", "flow", "instance", "rows_t")
    rows = []
    for i, (args, kw) in enumerate(calls):
        sb, tri_rows, ray_dir, tri = args[:4]
        shadow = kw.get("shadow_variant", args[7] if len(args) > 7 else False)
        mip_args = kw.get("mip_args", args[8] if len(args) > 8 else None)
        mips = mip_args is not None and sb.features.has_mips and not shadow
        before = tc.launch_counts.hit_shade_launches
        got = tc.hit_shade(*args, **kw)
        launches = tc.launch_counts.hit_shade_launches - before
        want, plain_ms = timed(lambda: shading.shade_hits_plain(*args, **kw))
        equal = {}
        for name, g, w in zip(names, got, want):
            same = g == w
            if g.dtype == torch.float32:
                same = (g.view(torch.int32) == w.view(torch.int32)) | (
                    torch.isnan(g) & torch.isnan(w))
            equal[name] = bool(same.all())
        del got, want
        ms = time_ms(lambda: tc.hit_shade(*args, **kw), reps=25)
        m = tri.shape[0]
        live = int((tri >= 0).sum())
        distinct = int(torch.unique(tri[tri >= 0]).numel())
        n_bytes = (m * (HIT_LANE_IN_BYTES + tri.element_size() - 4
                        + (HIT_MIP_IN_BYTES if mips else 0)
                        + (HIT_SHADOW_OUT_BYTES if shadow else HIT_LANE_OUT_BYTES))
                   + distinct * HIT_ROW_BYTES)
        bms, by = bound_ms(n_bytes, 0)
        row = dict(phase=tag, call=i, lanes=m, live_lanes=live,
                   distinct_triangles=distinct, shadow_variant=bool(shadow),
                   mips=mips, features=sb.features._asdict(), bit_equal=equal,
                   hit_shade_launches=launches, bytes=n_bytes, ms=ms,
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   max_abs_err=0.0 if all(equal.values()) else None)
        emit(row)
        check(all(equal.values()),
              f"{tag} call {i}: the kernel differs from the plain version: {equal}")
        check(launches == 1, f"{tag} call {i}: {launches} launches, not 1")
        rows.append(row)
    out = dict(phase=f"{tag}_draw", calls=len(rows),
               lanes=[r["lanes"] for r in rows],
               live_lanes=[r["live_lanes"] for r in rows], max_abs_err=0.0,
               ms=sum(r["ms"] for r in rows),
               plain_ms=sum(r["plain_ms"] for r in rows),
               bound_ms=sum(r["bound_ms"] for r in rows), bound_by="bytes")
    emit(out)
    return out


def phase_k1_k2_bounce():
    """K1 and K2 on the regrouped bounce launches of a castle GI
    1280x720 frame (the frame's last closest-hit and last occlusion
    launches), after one settling draw. Also returns that frame's
    framebuffer, drawn with max_reflections 0."""
    import torch
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    dev, _, view = build_castle_scene(GI_W, GI_H, di_samples=1,
                                      gi_samples=1, denoiser=True)
    view.max_reflections = 0
    dev.draw()  # settles the alpha boost ladder, fills the history
    seen = capture_launches(dev.draw)
    fb = view.framebuffer().copy()  # phase_reflections' plain frame
    del dev, view
    calls = seen["trace_opaque_blocks"], seen["trace_shadow_blocks"]
    check(len(calls[0]) >= 2 and len(calls[1]) >= 2,
          f"the castle GI frame launched K1/K2 {[len(c) for c in calls]} times")
    k1 = phase_k1("k1_bounce", calls[0][-1])
    k2 = phase_k2("k2_bounce", calls[1][-1])
    del seen, calls
    torch.cuda.empty_cache()
    return k1, k2, fb


def phase_reflections(plain_fb):
    """The castle GI frame with two reflection bounces (bench config 4
    at native size): one settling draw, one draw whose launches are
    recorded, then REFL_FRAMES frames through Device.draw() with the
    launch counts set to 0 just before and read just after. The recorded
    draw's frame must differ from plain_fb, the same castle drawn as
    often with max_reflections 0, on the pixels that seed a reflection
    (refl_alpha > 0), and equal it elsewhere up to REFL_ELSEWHERE_TOL per
    channel. Returns (row, the recorded launches)."""
    import numpy as np
    import torch
    from rt64tpu_torch.pipeline import framegraph as fg
    from rt64tpu_torch.utils import profiling
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    dev, _, view = build_castle_scene(GI_W, GI_H, di_samples=1,
                                      gi_samples=1, denoiser=True)
    view.max_reflections = REFL_BOUNCES
    dev.draw()  # settles the alpha boost ladder, fills the history
    seen = capture_launches(dev.draw)
    fb = view.framebuffer().copy()
    out, cfg = view._renderer._last, view._renderer._last_cfg
    check(cfg.max_reflections == REFL_BOUNCES,
          f"the castle frame ran {cfg.max_reflections} reflection bounces")
    moat = fg.to_image(cfg, out.gbuffers.refl_alpha > 0).cpu().numpy()
    diff = np.abs(fb[..., :3].astype(np.int16)
                  - plain_fb[..., :3].astype(np.int16)).max(axis=-1)
    refl = out.reflection.abs().amax(dim=0)
    seeds = out.gbuffers.refl_alpha > 0
    compare = dict(
        refl_pixels=int(moat.sum()),
        moat_changed=float((diff[moat] > REFL_CHANGED_MIN).mean()),
        moat_diff_mean=float(diff[moat].mean()),
        elsewhere_within_tol=float((diff[~moat] <= REFL_ELSEWHERE_TOL).mean()),
        elsewhere_equal=float((diff[~moat] == 0).mean()),
        elsewhere_diff_max=int(diff[~moat].max()))
    reflection = dict(
        refl_alpha_fraction=float(seeds.float().mean()),
        reflection_nonzero_on_seeds=float((refl[seeds] > 0).float().mean()),
        reflection_max_off_seeds=float(refl[~seeds].max()),
        reflection_mean_on_seeds=float(out.reflection[:, seeds].mean()),
        reflection_max=float(refl.max()),
        refl_alpha_mean_on_seeds=float(out.gbuffers.refl_alpha[seeds].mean()))
    del out
    profiling.reset_frame_stats()
    # The frame record counts while a profiler records: these frames' ms
    # include the CPU profiler's cost.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        frame_ms, counts, peak = draw_frames(dev, REFL_FRAMES)
    stats = profiling.frame_stats()
    profiling.reset_frame_stats()
    # A bounce with no live mirror ray is not issued.
    issued = (REFL_BOUNCES * stats["renders"]
              - stats["reflection_bounces_skipped"])
    row = frame_row("reflections", view, REFL_FRAMES, frame_ms, counts, peak)
    row.update(width=GI_W, height=GI_H, max_reflections=REFL_BOUNCES,
               elsewhere_tolerance=REFL_ELSEWHERE_TOL,
               changed_threshold=REFL_CHANGED_MIN,
               vs_max_reflections_0=compare, bounces_issued=issued,
               reflection_live_rays=stats["reflection_live_rays"], **reflection)
    emit(row)
    check_frame(row, view, GI_W, GI_H)
    k1 = counts["opaque_launches"]
    renders = stats["renders"]
    check(renders >= REFL_FRAMES and issued >= renders,
          f"{renders} renders and {issued} reflection bounces issued in "
          f"{REFL_FRAMES} reflection frames")
    check(k1 == 2 * renders + issued,
          f"K1 launched {k1} times in {renders} reflection renders, not 2 a "
          f"render and one a bounce issued ({issued})")
    check(counts["opaque_mt_launches"] == 0 and counts["shadow_mt_launches"] == 0,
          "the castle frame (below the size switch) launched K3 or K4")
    check(0.0 < reflection["refl_alpha_fraction"] < 0.5,
          f"refl_alpha > 0 on {reflection['refl_alpha_fraction']} of the pixels")
    check(reflection["reflection_max_off_seeds"] == 0.0,
          "the reflection plane is non-zero where no reflection was seeded")
    check(reflection["reflection_nonzero_on_seeds"] > 0.5,
          "the reflection plane is zero on the moat")
    check(compare["moat_changed"] >= 0.5,
          f"reflections changed {compare['moat_changed']} of the moat pixels")
    check(compare["elsewhere_within_tol"] >= 0.999,
          f"{1 - compare['elsewhere_within_tol']} of the pixels without a "
          f"reflection differ by more than {REFL_ELSEWHERE_TOL}")
    del dev, view
    torch.cuda.empty_cache()
    return row, seen


def phase_k1_reflections(seen):
    """K1 on the recorded castle-refl draw's reflection launches (its
    closest-hit launches after the primary and the GI bounce): mirror rays
    from the moat, unregrouped, on the live rays' bundles alone. A second
    bounce with no live ray (the castle's usual case) is not launched."""
    calls = seen["trace_opaque_blocks"]
    check(3 <= len(calls) <= 2 + REFL_BOUNCES,
          f"the settled castle-refl draw launched K1 {len(calls)} times")
    first = phase_k1("k1_refl1", calls[2])
    if len(calls) > 3:
        first["last"] = phase_k1(f"k1_refl{len(calls) - 2}", calls[-1])
    return first


def phase_k3_reflection(seen):
    """K3 on the first reflection launch of a recorded large-castle GI
    1280x720 draw with two reflection bounces."""
    from rt64tpu_torch.ops import tracer_cuda as tc

    calls = seen["trace_opaque_mt_blocks"]
    check(3 <= len(calls) <= 2 + REFL_BOUNCES,
          f"the large-castle reflection draw launched K3 {len(calls)} times")
    row = closest_hit_phase("k3_refl1", calls[2], tc.trace_opaque_mt_blocks,
                            tc.trace_opaque_mt_plain, FLOPS_K3)
    row["launches_per_frame"] = len(calls)
    return row


def card_vs_cpu(build, frames, prepare=None):
    """Draw a scene `frames` times on the card and on the CPU from the
    same scene function; returns (SSIM of the last frames, the card's launch
    counts, seconds per side)."""
    from rt64tpu_torch.ops import tracer_cuda as tc
    from rt64tpu_torch.utils.ssim import ssim

    fbs, seconds = {}, {}
    for where in ("cuda", "cpu"):
        if where == "cuda":
            tc.launch_counts.reset()
        t0 = time.perf_counter()
        dev, scene, view = build(where)
        if prepare is not None:
            prepare(scene)
        for _ in range(frames):
            dev.draw()
        fbs[where] = view.framebuffer()
        seconds[where] = time.perf_counter() - t0
        if where == "cuda":
            counts = dict(vars(tc.launch_counts))
    return ssim(fbs["cuda"][..., :3], fbs["cpu"][..., :3]), counts, seconds


def phase_secondary_small():
    """Card against CPU, SSIM >= 0.99, on (a) the castle at 160x120 with
    GI, the denoiser and two reflection bounces, two frames, and (b) the
    sample scene with_glass at 160x120, gi_samples 1, two reflection
    bounces, its glass sphere made translucent so that its refraction
    rays live (K2 traces their one-light shadow rays)."""
    from rt64tpu_torch.utils.castle_scene import build_castle_scene
    from rt64tpu_torch.utils.testscenes import (build_sample_scene,
                                                make_glass_translucent)

    w, h = 160, 120

    def castle(where):
        dev, scene, view = build_castle_scene(w, h, di_samples=1, gi_samples=1,
                                              denoiser=True, device=where)
        view.max_reflections = REFL_BOUNCES
        return dev, scene, view

    s, counts, seconds = card_vs_cpu(castle, 2)
    emit(dict(phase="refl_small_card_vs_cpu", width=w, height=h, frames=2,
              max_reflections=REFL_BOUNCES, ssim=s, seconds=seconds, **counts))
    check(s >= 0.99, f"castle reflection SSIM card vs CPU {s} < 0.99")
    check(counts["opaque_launches"] >= 2 * (2 + REFL_BOUNCES),
          f"two castle reflection frames launched K1 {counts}")

    def glass(where):
        dev, scene, view = build_sample_scene(w, h, di_samples=1, gi_samples=1,
                                              with_glass=True, device=where)
        view.max_reflections = REFL_BOUNCES
        return dev, scene, view

    s, counts, seconds = card_vs_cpu(glass, 1, prepare=make_glass_translucent)
    emit(dict(phase="glass_small_card_vs_cpu", width=w, height=h, frames=1,
              max_reflections=REFL_BOUNCES, ssim=s, seconds=seconds, **counts))
    check(s >= 0.99, f"glass scene SSIM card vs CPU {s} < 0.99")
    # primary, GI bounce, refraction, the reflection bounces with a live
    # mirror ray (the first at least; a bounce with none is not
    # launched); direct light, bounce light, refraction light
    check(counts["opaque_launches"] >= 4
          and counts["shadow_launches"] >= 3,
          f"the glass frame launched K1/K2 {counts}")


def phase_mip_lod():
    """The minification floor of tests/test_miplod.py at 128x96 with
    SHADER_MIP_LOD_ENABLED, card against CPU (SSIM >= 0.99), and the
    dealiasing that test asserts, on the card: over the floor band the
    flag cuts the pixel standard deviation below 0.35 of the flag-off
    frame's and keeps the band mean within 0.02."""
    import numpy as np
    from rt64tpu_torch.utils.testscenes import build_mip_floor

    s, counts, seconds = card_vs_cpu(
        lambda where: build_mip_floor(True, device=where), 1)
    frames = {}
    for mip in (False, True):
        dev, _, view = build_mip_floor(mip)
        dev.draw()
        frames[mip] = np.asarray(view.framebuffer()[..., :3], np.float64) / 255.0
    band = slice(int(96 * 0.52), int(96 * 0.78))
    std_off, std_on = float(frames[False][band].std()), float(frames[True][band].std())
    mean_gap = abs(float(frames[True][band].mean()) - float(frames[False][band].mean()))
    emit(dict(phase="mip_lod", width=128, height=96, ssim_card_vs_cpu=s,
              band_std_off=std_off, band_std_on=std_on,
              band_std_ratio=std_on / std_off, band_mean_gap=mean_gap,
              seconds=seconds, **counts))
    check(s >= 0.99, f"mip floor SSIM card vs CPU {s} < 0.99")
    check(std_off > 0.03, f"the flag-off floor does not alias ({std_off})")
    check(std_on < 0.35 * std_off, f"mip LOD band std {std_on} vs {std_off}")
    check(mean_gap < 0.02, f"mip LOD moved the band mean by {mean_gap}")


def same_rays_other_table(tag, prep_call, prep, wrapper, extra=()):
    """Time the 64-triangle kernel (K1 or K2) on the rays and scene of a
    recorded 128-triangle launch: the table fits either way, so this is
    what the size switch costs or pays on this card. The switch constant
    is raised for the prep alone."""
    import torch
    from rt64tpu_torch.ops import tracer_cuda as tc

    args, _ = prep_call
    table_bytes = tc.RESIDENT_TABLE_BYTES
    tc.RESIDENT_TABLE_BYTES = 1 << 40
    try:
        p = prep(*args)
    finally:
        tc.RESIDENT_TABLE_BYTES = table_bytes
    check(not p.mt, f"{tag}: the prep did not build the Woop table")
    call = lambda: wrapper(p.rays8, p.clusters, p.visits, p.counts,
                           p.entries, *extra, packed=p.packed)
    out = call()
    torch.cuda.synchronize()
    ms = time_ms(call, reps=25)
    row = dict(phase=tag, rays=p.rays8.shape[1], blocks=p.counts.shape[0],
               clusters=p.clusters.shape[0] - 1,
               visits_listed=int(p.counts.sum()), ms=ms)
    return row, out


def phase_k3(seen):
    """K3 on the frame's primary launch (its first closest-hit launch),
    K1 on the same rays and scene, and K3 on the frame's last closest-hit
    launch: the regrouped GI bounce rays."""
    from rt64tpu_torch.ops import tracer_cuda as tc

    calls = seen["trace_opaque_mt_blocks"]
    check(len(calls) >= 2, f"the large GI frame launched K3 {len(calls)} times")
    call = calls[0]
    row = closest_hit_phase("k3", call, tc.trace_opaque_mt_blocks,
                            tc.trace_opaque_mt_plain, FLOPS_K3)
    row["bounce"] = closest_hit_phase(
        "k3_bounce", calls[-1], tc.trace_opaque_mt_blocks,
        tc.trace_opaque_mt_plain, FLOPS_K3)
    cull = call[0][5]
    k1, (_, tri_w, _, _, _) = same_rays_other_table(
        "k1_on_k3_rays", seen["prepare_opaque"][0], tc.prepare_opaque,
        tc.trace_opaque_blocks, extra=(cull,))
    _, tri_m, _, _, _ = tc.trace_opaque_mt_blocks(*call[0], **call[1])
    k1["tri_agreement_with_k3"] = (tri_w == tri_m).float().mean().item()
    k1["k3_ms"] = row["ms"]
    k1["k3_over_k1"] = row["ms"] / k1["ms"]
    emit(k1)
    check(k1["tri_agreement_with_k3"] >= 0.999,
          f"K1 and K3 agree on {k1['tri_agreement_with_k3']} of the rays")
    return row


def phase_k4(seen):
    """K4 on the frame's largest occlusion launch (the direct-light
    shadow rays), K2 on the same rays and scene, and K4 on the frame's
    last occlusion launch: the regrouped shadow rays of the bounce
    points."""
    from rt64tpu_torch.ops import tracer_cuda as tc

    calls = seen["trace_shadow_mt_blocks"]
    check(len(calls) >= 2, f"the large GI frame launched K4 {len(calls)} times")
    call = largest(calls)
    check(call is not calls[-1], "the bounce-shadow launch is the largest")
    row = occlusion_phase("k4", call, tc.trace_shadow_mt_blocks,
                          tc.trace_shadow_mt_plain, FLOPS_K4)
    row["bounce"] = occlusion_phase(
        "k4_bounce", calls[-1], tc.trace_shadow_mt_blocks,
        tc.trace_shadow_mt_plain, FLOPS_K4)
    k2, bl_w = same_rays_other_table(
        "k2_on_k4_rays", largest(seen["prepare_shadow"]), tc.prepare_shadow,
        tc.trace_shadow_blocks)
    bl_m = tc.trace_shadow_mt_blocks(*call[0], **call[1])
    check(bl_w.shape == bl_m.shape, "K2 and K4 saw different ray batches")
    k2["blocked_agreement_with_k4"] = (bl_w == bl_m).float().mean().item()
    k2["k4_ms"] = row["ms"]
    k2["k4_over_k2"] = row["ms"] / k2["ms"]
    emit(k2)
    check(k2["blocked_agreement_with_k4"] >= 0.999,
          f"K2 and K4 agree on {k2['blocked_agreement_with_k4']} of the rays")
    return row


def draw_frames(dev, frames):
    """Draw `frames` frames with the launch counts set to 0 just before
    and read just after: (frame ms list, counts dict, peak bytes)."""
    import torch
    from rt64tpu_torch.ops import tracer_cuda as tc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc.launch_counts.reset()
    frame_ms = []
    for _ in range(frames):
        t0 = time.perf_counter()
        dev.draw()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    counts = dict(vars(tc.launch_counts))
    return frame_ms, counts, torch.cuda.max_memory_allocated()


def frame_row(phase, view, frames, frame_ms, counts, peak):
    inst = view._renderer.instance_plane()
    return dict(phase=phase, frames=frames,
                frame_ms_median=statistics.median(frame_ms),
                frame_ms_min=min(frame_ms[1:]), frame_ms_max=max(frame_ms[1:]),
                frame_ms_first=frame_ms[0], frame_ms=frame_ms, **counts,
                launches_per_frame={k: v / frames for k, v in counts.items()},
                alpha_boost=view._renderer.alpha_boost,
                alpha_dropped=int(view._renderer._last.alpha_dropped),
                max_memory_allocated=peak,
                hit_fraction=float((inst >= 0).mean()))


def check_frame(row, view, w, h):
    import numpy as np

    fb = view.framebuffer()
    check(fb.shape == (h, w, 4) and fb.dtype == np.uint8,
          f"framebuffer {fb.shape} {fb.dtype}")
    check(fb[..., :3].std() > 1.0, "framebuffer is constant")
    check(row["hit_fraction"] > 0.0, "no hits in the instance plane")
    check(row["alpha_dropped"] == 0,
          f"alpha_dropped {row['alpha_dropped']} after the boost ladder")


def phase_main_path():
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    dev, _, view = build_castle_scene(CASTLE_W, CASTLE_H, di_samples=1,
                                      gi_samples=0)
    view.max_reflections = 0
    frame_ms, counts, peak = draw_frames(dev, MAIN_FRAMES)
    row = frame_row("main_path", view, MAIN_FRAMES, frame_ms, counts, peak)
    emit(row)
    check_frame(row, view, CASTLE_W, CASTLE_H)
    k1, k2 = counts["opaque_launches"], counts["shadow_launches"]
    check(k1 >= MAIN_FRAMES, f"K1 launched {k1} times in {MAIN_FRAMES} frames")
    check(k2 >= MAIN_FRAMES, f"K2 launched {k2} times in {MAIN_FRAMES} frames")
    sweeps = counts["alpha_sweep_launches"]
    check(sweeps >= MAIN_FRAMES,
          f"the alpha sweep launched {sweeps} times in {MAIN_FRAMES} frames")
    shades = counts["hit_shade_launches"]
    check(shades >= MAIN_FRAMES,
          f"the hit shader launched {shades} times in {MAIN_FRAMES} frames")
    culls = counts["alpha_cull_launches"]
    check(culls >= MAIN_FRAMES,
          f"the alpha cull launched {culls} times in {MAIN_FRAMES} frames")
    check(counts["opaque_mt_launches"] == 0 and counts["shadow_mt_launches"] == 0,
          "the castle frame (below the size switch) launched K3 or K4")
    return row


def build_large_castle():
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    dev, _, view = build_castle_scene(
        LARGE_W, LARGE_H, di_samples=1, gi_samples=1, denoiser=True,
        terrain_n=LARGE_TERRAIN_N)
    view.max_reflections = 0
    return dev, view


def phase_large_gi():
    from rt64tpu_torch.ops import tracer_cuda as tc

    dev, view = build_large_castle()
    frame_ms, counts, peak = draw_frames(dev, LARGE_FRAMES)
    row = frame_row("large_gi", view, LARGE_FRAMES, frame_ms, counts, peak)
    r = view._renderer
    hist_len = r._last.indirect_accum[3]
    row.update(
        width=LARGE_W, height=LARGE_H, terrain_n=LARGE_TERRAIN_N,
        triangles=r.packer.triangle_count,
        triangle_bucket=int(r._sb.tri_valid.shape[0]),
        clusters_resident=tc.clusters_resident(int(r._sb.tri_valid.shape[0])),
        gi_hist_len_max=float(hist_len.max()),
        gi_hist_len_mean=float(hist_len.mean()))
    emit(row)
    check_frame(row, view, LARGE_W, LARGE_H)
    check(not row["clusters_resident"],
          f"bucket {row['triangle_bucket']} lies below the size switch")
    k3, k4 = counts["opaque_mt_launches"], counts["shadow_mt_launches"]
    check(k3 >= LARGE_FRAMES, f"K3 launched {k3} times in {LARGE_FRAMES} frames")
    check(k4 >= LARGE_FRAMES, f"K4 launched {k4} times in {LARGE_FRAMES} frames")
    check(counts["opaque_launches"] == 0 and counts["shadow_launches"] == 0,
          "the large frame launched K1 or K2")
    check(row["gi_hist_len_max"] > 1.0, "GI history was never reprojected")
    return row


def phase_gi_small():
    """GI and regrouping through K1/K2: the 16,384-bucket castle, two
    frames (the second reads history), card against CPU. 160x120 keeps
    the CPU side, which runs the plain twins, under a minute."""
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    w, h = 160, 120

    def castle(where):
        dev, scene, view = build_castle_scene(w, h, di_samples=1, gi_samples=1,
                                              denoiser=True, device=where)
        view.max_reflections = 0
        return dev, scene, view

    s, counts, seconds = card_vs_cpu(castle, 2)
    emit(dict(phase="gi_small_card_vs_cpu", width=w, height=h, frames=2,
              ssim=s, seconds=seconds, **counts))
    check(s >= 0.99, f"castle GI SSIM card vs CPU {s} < 0.99")
    check(counts["opaque_launches"] >= 4 and counts["shadow_launches"] >= 4,
          f"two GI frames launched K1/K2 {counts}")


def phase_sample():
    from rt64tpu_torch.utils.testscenes import build_sample_scene

    def sample(where):
        dev, scene, view = build_sample_scene(320, 240, di_samples=1,
                                              gi_samples=0, device=where)
        view.max_reflections = 0
        return dev, scene, view

    s, _, _ = card_vs_cpu(sample, 1)
    emit(dict(phase="sample_card_vs_cpu", width=320, height=240, ssim=s))
    check(s >= 0.99, f"sample SSIM card vs CPU {s} < 0.99")


# The castle-raster frame (bench config 4's ray mix at native size, the
# castle's sky plane removed, testscenes.raster_layers drawn over it: a
# raster-background skybox and a HUD of 12 textured quads).
RASTER_FRAMES = 10
# HUD gate: pixels whose centres lie at least this far (px) inside the
# HUD triangles count as covered, those at least this far outside as
# uncovered (the edge test in float64 against the frame's float32).
HUD_EDGE_PX = 1e-3
HUD_CHANGED_MIN = 2  # per RGB8 channel
HUD_CHANGED_SHARE = 0.9
BG_SHARE = 0.99
GOLDEN_PNG = "tests/golden/sample_160x120.png"
# Debug views, card against CPU on one castle-raster frame's outputs: max
# abs per mode; the flow view's dist < 1 threshold may flip this share
# of the pixels.
DEBUG_TOL = 1e-5
FLOW_FLIP_SHARE = 1e-4
DEBUG_UNKNOWN_MODE = 23


def hud_coverage(rows, irows, w, h):
    """(covered, maybe) (h, w) masks of the pixel centres inside any of
    the packed raster rows, from a float64 edge test written here (not
    the port's): covered lies HUD_EDGE_PX inside a triangle, maybe not
    HUD_EDGE_PX outside all of them."""
    import numpy as np
    from rt64tpu_torch.ops.raster import RR_INST, RR_POS
    from rt64tpu_torch.pipeline import rows as R

    X, Y = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    covered = np.zeros((h, w), bool)
    maybe = np.zeros((h, w), bool)
    for row in np.asarray(rows, np.float64):
        vx, vy, vw, vh = irows[int(row[RR_INST]), R.I_VIEWPORT:R.I_VIEWPORT + 4]
        vw, vh = (vw if vw > 0 else w), (vh if vh > 0 else h)
        c = row[RR_POS:RR_POS + 12].reshape(3, 4)
        sx = vx + (c[:, 0] / c[:, 3] * 0.5 + 0.5) * vw
        sy = vy + (0.5 - c[:, 1] / c[:, 3] * 0.5) * vh
        area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
        sign = 1.0 if area >= 0 else -1.0
        dists = []
        for a, b in ((0, 1), (1, 2), (2, 0)):
            e = (sx[b] - sx[a]) * (Y - sy[a]) - (sy[b] - sy[a]) * (X - sx[a])
            dists.append(sign * e / max(np.hypot(sx[b] - sx[a], sy[b] - sy[a]), 1e-30))
        low = np.minimum(np.minimum(dists[0], dists[1]), dists[2])
        covered |= low >= HUD_EDGE_PX
        maybe |= low > -HUD_EDGE_PX
    return covered, maybe


def launches(fn):
    """CUDA kernels that one fn() launches, by torch.profiler."""
    return profiled(fn)[0]


def profiled(fn):
    """(CUDA kernels one fn() launches, their summed device ms), by
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def raster_scene(hud_quads, background):
    """The castle-raster scene with a chosen part of its raster layers
    (hud_quads=0 and background=False: the castle-refl frame without
    its sky plane)."""
    from rt64tpu_torch.utils.castle_scene import build_castle_scene
    from rt64tpu_torch.utils.testscenes import raster_layers

    dev, scene, view = build_castle_scene(GI_W, GI_H, di_samples=1,
                                          gi_samples=1, denoiser=True)
    view.max_reflections = REFL_BOUNCES
    view.set_sky_plane(None)
    if hud_quads or background:
        raster_layers(scene, dev, hud_quads=hud_quads, background=background)
    return dev, view


def phase_raster():
    """The castle-raster frame at 1280x720. Two draws of it and of the same
    scene without the HUD and without any raster layer give the gates:
    HUD: against the frame without the HUD, every pixel outside the HUD
    triangles is bit-equal and HUD_CHANGED_SHARE of the covered ones
    change by more than HUD_CHANGED_MIN; background: BG_SHARE of the
    pixels that are black without any raster layer (primary misses with
    no sky plane) are not black with the skybox. Then RASTER_FRAMES
    frames through Device.draw() with the launch counts set to 0 just
    before and read just after, all launches of one profiled frame, and
    the device ms and launches of each raster pass and of one
    environment-map gather over the frame's 921,600 rays (one GI and two
    reflection passes run one each). K1 launches 2 a render and one a
    reflection bounce issued (a bounce with no live mirror ray is not).
    Returns (row, the scene's device, view)."""
    import numpy as np
    import torch
    from rt64tpu_torch.ops import sky
    from rt64tpu_torch.pipeline import framegraph as fg
    from rt64tpu_torch.utils import profiling

    fbs = {}
    for key, hud, bg in (("none", 0, False), ("bg", 0, True), ("full", 12, True)):
        dev, view = raster_scene(hud, bg)
        dev.draw()
        dev.draw()
        fbs[key] = view.framebuffer()[..., :3].astype(np.int16)
        if key != "full":
            del dev, view
            torch.cuda.empty_cache()
    r = view._renderer
    host = r._sb.raster_host
    covered, maybe = hud_coverage(host.fg, host.instance_rows, GI_W, GI_H)
    hud_diff = np.abs(fbs["full"] - fbs["bg"]).max(axis=-1)
    black = (fbs["none"] == 0).all(axis=-1)
    bg_changed = (fbs["bg"] != fbs["none"]).any(axis=-1)
    gates = dict(
        hud_covered_pixels=int(covered.sum()),
        hud_changed_share=float((hud_diff[covered] > HUD_CHANGED_MIN).mean()),
        hud_outside_equal=bool((hud_diff[~maybe] == 0).all()),
        hud_outside_diff_max=int(hud_diff[~maybe].max()),
        black_without_layers_share=float(black.mean()),
        black_lit_by_skybox_share=float((fbs["bg"][black] > 0).any(-1).mean()),
        other_pixels_changed_share=float(bg_changed[~black].mean()))

    profiling.reset_frame_stats()
    # As in phase_reflections: the record counts the bounces issued while
    # a profiler records, and these frames' ms include its cost.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        frame_ms, counts, peak = draw_frames(dev, RASTER_FRAMES)
    stats = profiling.frame_stats()
    profiling.reset_frame_stats()
    renders = stats["renders"]
    # A bounce with no live mirror ray is not issued.
    issued = REFL_BOUNCES * renders - stats["reflection_bounces_skipped"]
    row = frame_row("raster", view, RASTER_FRAMES, frame_ms, counts, peak)
    out, cfg = r._last, r._last_cfg
    sb = r._sb
    ones = torch.ones((1, GI_H, GI_W), device="cuda")
    base = torch.cat([r._background_planes(cfg), ones], 0)
    disp = torch.cat([out.image, ones], 0)
    bg_pass = lambda: fg._raster_layer(base, sb, "bg")
    fg_pass = lambda: fg._raster_layer(disp, sb, "fg")
    planes = bg_pass()[:3]
    dirs = torch.randn((3, GI_W * GI_H),
                       generator=torch.Generator().manual_seed(0)).to("cuda")
    env = lambda: sky.sample_background_env(planes, dirs)
    row.update(
        width=GI_W, height=GI_H, max_reflections=REFL_BOUNCES, hud_quads=12,
        renders=renders, bounces_issued=issued,
        raster_bg_triangles=int(host.bg.shape[0]),
        raster_fg_triangles=int(host.fg.shape[0]),
        launches_per_frame_all=launches(dev.draw),
        bg_pass_ms=time_ms(bg_pass, 10), bg_pass_launches=launches(bg_pass),
        fg_pass_ms=time_ms(fg_pass, 10), fg_pass_launches=launches(fg_pass),
        env_gather_ms=time_ms(env, 10), env_gather_launches=launches(env),
        **gates)
    emit(row)
    check_frame(row, view, GI_W, GI_H)
    check(renders >= RASTER_FRAMES and issued >= renders,
          f"{renders} renders and {issued} reflection bounces issued in "
          f"{RASTER_FRAMES} castle-raster frames")
    check(counts["opaque_launches"] == 2 * renders + issued
          and counts["shadow_launches"] >= 2 * RASTER_FRAMES,
          f"K1/K2 launched {counts} in {RASTER_FRAMES} castle-raster frames "
          f"({renders} renders, {issued} reflection bounces issued): K1 not "
          f"2 a render and one a bounce issued")
    check(counts["opaque_mt_launches"] == 0 and counts["shadow_mt_launches"] == 0,
          "the castle-raster frame (below the size switch) launched K3 or K4")
    check(sb.features.has_raster_bg and host.fg.shape[0] == 24,
          "the castle-raster scene packed no raster background or not 24 HUD triangles")
    check(gates["hud_outside_equal"],
          f"pixels outside the HUD differ by up to {gates['hud_outside_diff_max']}")
    check(gates["hud_changed_share"] >= HUD_CHANGED_SHARE,
          f"the HUD changed {gates['hud_changed_share']} of its pixels")
    check(gates["black_without_layers_share"] > 0.05,
          "the frame without raster layers has no black (missed) pixels")
    check(gates["black_lit_by_skybox_share"] >= BG_SHARE,
          f"the skybox lit {gates['black_lit_by_skybox_share']} of the missed pixels")
    return row, dev, view


def phase_debug_views(dev, view):
    """The debug views of one castle-raster FrameOutputs: every mode and
    one unknown on the card tensors against the same function on their
    CPU copies (max abs DEBUG_TOL; the flow view may flip
    FLOW_FLIP_SHARE of its pixels); then one Device.draw() of the depth
    view, whose HUD must lie over it: outside the HUD the frame equals
    the plain depth view bit for bit, and the HUD changes its pixels
    (half the checker cells are white, which a white depth view can
    match, so a quarter of them is the bound)."""
    import numpy as np
    import torch
    from rt64tpu_torch import descriptors as d
    from rt64tpu_torch.pipeline import framegraph as fg

    out, cfg = view._renderer._last, view._renderer._last_cfg
    extra = (out.direct_accum, out.indirect_accum, out.filtered_direct,
             out.filtered_indirect, out.reflection, out.refraction)
    cpu = lambda t: t.cpu()
    g_cpu = fg.GBuffers(*map(cpu, out.gbuffers))
    extra_cpu = tuple(map(cpu, extra))
    modes = {}
    for mode in list(range(d.VISUALIZATION_MODE_COUNT)) + [DEBUG_UNKNOWN_MODE]:
        card = fg.debug_visualization(mode, cfg, out.gbuffers, *extra).cpu()
        want = fg.debug_visualization(mode, cfg, g_cpu, *extra_cpu)
        diff = (card - want).abs()
        modes[mode] = dict(max_abs=float(diff.max()),
                           differ_share=float((diff.amax(0) > DEBUG_TOL).float().mean()))
    del g_cpu, extra_cpu

    view.visualization_mode = d.VISUALIZATION_MODE_DEPTH
    dev.draw()
    view.visualization_mode = 0
    out, cfg = view._renderer._last, view._renderer._last_cfg
    fb = view.framebuffer()[..., :3].astype(np.int16)
    plain = fg.present_rgb8(fg.debug_visualization(
        d.VISUALIZATION_MODE_DEPTH, cfg, out.gbuffers, out.direct_accum,
        out.indirect_accum, out.filtered_direct, out.filtered_indirect,
        out.reflection, out.refraction)).cpu().numpy().astype(np.int16)
    host = view._renderer._sb.raster_host
    covered, maybe = hud_coverage(host.fg, host.instance_rows, GI_W, GI_H)
    diff = np.abs(fb - plain).max(axis=-1)
    row = dict(phase="debug_views", width=GI_W, height=GI_H, modes=modes,
               depth_view_outside_hud_equal=bool((diff[~maybe] == 0).all()),
               depth_view_hud_changed_share=float((diff[covered] > HUD_CHANGED_MIN).mean()))
    emit(row)
    for mode, m in modes.items():
        if mode == d.VISUALIZATION_MODE_FLOW:
            check(m["differ_share"] <= FLOW_FLIP_SHARE,
                  f"flow view: {m['differ_share']} of the pixels differ card vs CPU")
        else:
            check(m["max_abs"] <= DEBUG_TOL,
                  f"debug view {mode}: max abs {m['max_abs']} card vs CPU")
    check(row["depth_view_outside_hud_equal"],
          "the depth view with the HUD differs from the plain depth view outside the HUD")
    check(row["depth_view_hud_changed_share"] >= 0.25,
          f"the HUD changed {row['depth_view_hud_changed_share']} of its "
          "pixels over the depth view")
    return row


def phase_golden():
    """The port's golden frame on the card: the sample scene at 160x120
    with a HUD triangle, two draws, at SSIM >= 0.98 against the
    checked-in PNG (the JAX test's bound), read by the port's decoder."""
    from rt64tpu_torch.utils.assets import read_image
    from rt64tpu_torch.utils.ssim import ssim
    from rt64tpu_torch.utils.testscenes import build_sample_scene, hud_triangle

    dev, scene, view = build_sample_scene(width=160, height=120)
    hud_triangle(scene, dev, color=(1.0, 0.15, 0.1, 0.85))
    dev.draw()
    dev.draw()
    s = ssim(view.framebuffer()[..., :3], read_image(GOLDEN_PNG)[..., :3])
    emit(dict(phase="golden", width=160, height=120, png=GOLDEN_PNG, ssim=s))
    check(s >= 0.98, f"golden frame SSIM {s} < 0.98")


def phase_raster_small():
    """Card against CPU, SSIM >= 0.99: the sample scene at 160x120 with
    its sky plane removed and the raster skybox and HUD, gi 1, two
    draws."""
    from rt64tpu_torch.utils.testscenes import build_sample_scene, raster_layers

    def layered(where):
        dev, scene, view = build_sample_scene(160, 120, di_samples=1,
                                              gi_samples=1, device=where)
        view.set_sky_plane(None)
        raster_layers(scene, dev)
        return dev, scene, view

    s, counts, seconds = card_vs_cpu(layered, 2)
    emit(dict(phase="raster_small_card_vs_cpu", width=160, height=120,
              frames=2, ssim=s, seconds=seconds, **counts))
    check(s >= 0.99, f"layered sample SSIM card vs CPU {s} < 0.99")


# Bench configs 2-4 as bench.py builds them: (display size, gi_samples,
# max_reflections, frames after the settling draw); the castle with
# di_samples 1 and the denoiser left at build_castle_scene's default,
# the FSR slot in auto mode.
BENCH_UPSCALED = {
    2: ((640, 480), 0, 0, 5),
    3: ((1280, 720), 1, 0, 5),
    4: ((1280, 720), 1, 2, 10),
}
# quality_resolution(AUTO, ...): 0.77 of the display, snapped to 64x8.
BENCH_RENDER = {2: (512, 368), 3: (960, 552), 4: (960, 552)}
# A draw with a fresh temporal history is the bilinear upscale.
RESET_TOL = 1e-5
JITTER_DISTINCT_MIN = 3


class RecordJitter:
    """Records gp.pixel_jitter of every frame the view renders, by
    wrapping framegraph.render_frame while the block runs."""

    def __enter__(self):
        from rt64tpu_torch.pipeline import framegraph as fg

        self.seen = []
        self._fg, self._render = fg, fg.render_frame

        def render(sb, gp, *args, **kw):
            self.seen.append(tuple(gp.pixel_jitter))
            return self._render(sb, gp, *args, **kw)

        fg.render_frame = render
        return self

    def __exit__(self, *exc):
        self._fg.render_frame = self._render


def phase_upscaled():
    """Bench configs 2, 3 and 4 as written (FSR auto: 640x480 from
    512x368, 1280x720 from 960x552) through Device.draw(): a settling
    draw, one draw with the temporal history dropped (a reset frame: the
    image must equal bilinear_resize(rt_output) to RESET_TOL; the
    settling draw climbs the alpha-boost ladder, whose re-renders
    consume the history), then the config's frames with the launch
    counts set to 0 just before and read just after, and one profiled
    frame. Returns {config: row}."""
    import numpy as np
    import torch
    from rt64tpu_torch import descriptors as d
    from rt64tpu_torch.ops import filters
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    rows = {}
    for n, ((w, h), gi, refl, frames) in BENCH_UPSCALED.items():
        dev, _, view = build_castle_scene(w, h, di_samples=1, gi_samples=gi)
        view.max_reflections = refl
        view.desc.upscaler = d.UPSCALER_FSR
        view.desc.upscaler_mode = d.UPSCALER_MODE_AUTO
        dev.draw()
        r = view._renderer
        r._temporal = None
        dev.draw()
        out, cfg = r._last, r._last_cfg
        want = filters.bilinear_resize(out.rt_output, h, w)
        reset_err = float((out.image - want).abs().max())
        with RecordJitter() as jit:
            frame_ms, counts, peak = draw_frames(dev, frames)
        row = frame_row(f"upscaled_bench{n}", view, frames, frame_ms, counts, peak)
        out, cfg = r._last, r._last_cfg
        all_launches, device_ms = profiled(dev.draw)
        row.update(
            config=n, display=(w, h), render=(cfg.rt_width, cfg.rt_height),
            gi_samples=gi, max_reflections=refl,
            upscaler=cfg.upscaler, image_shape=tuple(out.image.shape),
            temporal_shape=tuple(out.temporal.shape),
            reset_frame_max_abs=reset_err, jitter=jit.seen,
            jitter_distinct=len(set(jit.seen)),
            launches_per_frame_all=all_launches, device_ms_per_frame=device_ms,
            present_max=int(view.framebuffer()[..., :3].max()))
        emit(row)
        rows[n] = row
        check_frame(row, view, w, h)
        check(row["render"] == BENCH_RENDER[n],
              f"bench config {n} renders at {row['render']}, not {BENCH_RENDER[n]}")
        check(row["image_shape"] == (3, h, w),
              f"bench config {n} image {row['image_shape']}")
        check(counts["opaque_launches"] >= frames
              and counts["shadow_launches"] >= frames,
              f"K1/K2 launched {counts} in {frames} bench config {n} frames")
        check(counts["opaque_mt_launches"] == 0
              and counts["shadow_mt_launches"] == 0,
              f"bench config {n} launched K3 or K4")
        check(reset_err <= RESET_TOL,
              f"bench config {n}: the reset frame is {reset_err} from the "
              "bilinear upscale")
        check(row["jitter_distinct"] >= JITTER_DISTINCT_MIN,
              f"bench config {n}: {row['jitter_distinct']} jitter values")
        check(row["present_max"] > 0, f"bench config {n} presents black")
        del dev, view, r, out, want
        torch.cuda.empty_cache()
    return rows


def phase_upscalers_small():
    """Every upscaler slot card against CPU: the sample scene with its
    defaults at display 160x120, three draws each with FSR auto (render
    128x96), XeSS auto and DLSS performance, then one more FSR draw with
    upscaler_sharpness 0.5 and motion_blur_strength 0.5 over a sphere
    that moved since the last frame; SSIM >= 0.99 per frame. Also the
    learned residual at the DLSS draw's inputs, card against CPU."""
    import numpy as np
    import torch
    from rt64tpu_torch import descriptors as d
    from rt64tpu_torch.models import learned_upscaler
    from rt64tpu_torch.ops import filters, math3d
    from rt64tpu_torch.pipeline import framegraph as fg
    from rt64tpu_torch.utils.ssim import ssim
    from rt64tpu_torch.utils.testscenes import build_sample_scene

    w, h = 160, 120
    slots = {"fsr": (d.UPSCALER_FSR, d.UPSCALER_MODE_AUTO),
             "xess": (d.UPSCALER_XESS, d.UPSCALER_MODE_AUTO),
             "dlss": (d.UPSCALER_DLSS, d.UPSCALER_MODE_PERFORMANCE)}
    row = dict(phase="upscalers_small_card_vs_cpu", width=w, height=h)
    for name, (upscaler, mode) in slots.items():
        fbs, renders = {}, {}
        for where in ("cuda", "cpu"):
            dev, scene, view = build_sample_scene(w, h, upscaler=upscaler,
                                                  device=where)
            view.desc.upscaler_mode = mode
            fbs[where] = []
            for _ in range(3):
                dev.draw()
                fbs[where].append(view.framebuffer()[..., :3].copy())
            if name == "fsr":
                view.desc.upscaler_sharpness = 0.5
                view.desc.motion_blur_strength = 0.5
                sphere = scene.instances[0]
                sphere.desc.previous_transform = (
                    np.asarray(sphere.desc.transform, np.float32)
                    @ math3d.translation(-0.4, 0.0, 0.0))
                sphere.set_description(sphere.desc)
                dev.draw()
                fbs[where].append(view.framebuffer()[..., :3].copy())
            cfg = view._renderer._config()
            renders[where] = (cfg.rt_width, cfg.rt_height)
            if name == "dlss" and where == "cuda":
                out = view._renderer._last
                g = out.gbuffers
                x = filters.bilinear_resize(torch.cat([
                    out.rt_output, fg.to_image(cfg, g.depth)[None],
                    fg.to_image(cfg, g.flow), fg.to_image(cfg, g.reactive)[None],
                ], 0), h, w)
                res_card = learned_upscaler.residual(x).cpu()
                res_cpu = learned_upscaler.residual(x.cpu())
                row["dlss_residual_max_abs"] = float(res_card.abs().max())
                row["dlss_residual_card_vs_cpu_max_abs"] = float(
                    (res_card - res_cpu).abs().max())
        s = [ssim(a, b) for a, b in zip(fbs["cuda"], fbs["cpu"])]
        row[name] = dict(render=renders["cuda"], ssim=s,
                         max_abs=[int(np.abs(a.astype(np.int16) - b).max())
                                  for a, b in zip(fbs["cuda"], fbs["cpu"])])
        check(renders["cuda"] == renders["cpu"],
              f"{name}: render {renders} card vs CPU")
        check(min(s) >= 0.99, f"{name}: SSIM card vs CPU {s} < 0.99")
    emit(row)
    check(row["fsr"]["render"] == (128, 96), f"FSR auto renders {row['fsr']['render']}")
    return row


# Phase streamed: bench.py's measure_streamed on bench config 4 as written
# (castle 1280x720, di 1, gi 1, two reflection bounces, FSR auto, the
# denoiser at its default): STREAM_FRAMES settling draws (bench.py's warm
# loop), then blocks of STREAM_FRAMES timed frames in the order
# STREAM_ORDER, each pushing bench.py's angle cycle f = 0..STREAM_FRAMES-1;
# then per mode STREAM_WINDOW frames with the sync-debug mode on and one
# frame under the profiler.
STREAM_FRAMES = 10
STREAM_ORDER = ("full_sync", "pipelined", "pipelined", "full_sync")
STREAM_WINDOW = 5
# Frames of the profiled block of each mode, whose device time over its
# wall time (first draw to the last synchronize) gives the idle share.
STREAM_PROFILED = 4
# The ring must save at least this many host syncs a frame.
STREAM_SYNCS_SAVED_MIN = 2


def count_syncs(fn):
    """(fn(), {"file:line": count} of the synchronizing CUDA calls it
    made), as torch's sync-debug mode reports them."""
    import collections
    import os
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return out, dict(sites)


def phase_streamed():
    """Returns ({mode: row} for "full_sync" and "pipelined", the K1 and K2
    rows of one full-sync frame's largest launches)."""
    import collections

    import numpy as np
    import torch
    from rt64tpu_torch import bench
    from rt64tpu_torch.ops import tracer_cuda as tc
    from rt64tpu_torch.pipeline import framegraph as fg

    # bench config 4 driven by bench.py's push(f): instance 1 turns by
    # 0.03 f radians about y, the camera is pushed again, Device.draw().
    st = bench.StreamedLoop(*bench.build(*bench.CONFIGS[4]))
    for f in range(STREAM_FRAMES):
        st.push(f)
    r = st.view._renderer
    rows = {m: dict(phase=f"streamed_{m}", config=4, frames=0, draw_ms=[],
                    block_medians=[], loop_ms_per_frame=[], peak=0,
                    counts=collections.Counter(), ring=[])
            for m in STREAM_ORDER}
    for mode in STREAM_ORDER:
        row = rows[mode]
        pipelined = mode == "pipelined"
        if pipelined and not r.pipelined:
            r.pipelined = True
            for f in range(r.pipeline_depth):  # prime the ring
                st.push(f)
        r.pipelined = pipelined
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tc.launch_counts.reset()
        draw_ms = []
        t_loop = time.perf_counter()
        for f in range(STREAM_FRAMES):
            t0 = time.perf_counter()
            st.push(f)
            draw_ms.append((time.perf_counter() - t0) * 1e3)
            row["ring"].append(len(r._pending))
        torch.cuda.synchronize()
        row["loop_ms_per_frame"].append(
            (time.perf_counter() - t_loop) * 1e3 / STREAM_FRAMES)
        row["counts"].update(vars(tc.launch_counts))
        row["peak"] = max(row["peak"], torch.cuda.max_memory_allocated())
        row["draw_ms"] += draw_ms
        row["block_medians"].append(statistics.median(draw_ms))
        row["frames"] += STREAM_FRAMES

    out = {}
    for mode in ("full_sync", "pipelined"):
        row = rows[mode]
        r.pipelined = mode == "pipelined"
        if r.pipelined:
            for f in range(r.pipeline_depth):
                st.push(f)
        # The sync window: each draw's own RGB8 image kept on the card
        # (device ops only), the framebuffers on the host.
        drawn, presented, syncs, sites = [], [], [], collections.Counter()
        for f in range(STREAM_WINDOW):
            _, found = count_syncs(lambda: st.push(f))
            syncs.append(sum(found.values()))
            sites.update(found)
            drawn.append(fg.present_rgb8(r._last.image))
            presented.append(st.view.framebuffer()[..., :3].copy())
            row["ring"].append(len(r._pending))
        lag = r.pipeline_depth if r.pipelined else 0
        present_equal = [
            bool(np.array_equal(presented[i], drawn[i - lag].cpu().numpy()))
            for i in range(lag, STREAM_WINDOW)]

        def block():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in range(STREAM_PROFILED):
                st.push(f)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        box = []
        n_launch, device_ms = profiled(lambda: box.append(block()))
        counts = dict(row.pop("counts"))
        ring = row.pop("ring")
        draw_ms = row["draw_ms"]
        row.update(
            pipeline_depth=r.pipeline_depth if r.pipelined else 0,
            draw_ms_median=statistics.median(draw_ms), draw_ms_min=min(draw_ms),
            draw_ms_max=max(draw_ms),
            profiled_frames=STREAM_PROFILED,
            device_ms_per_frame=device_ms / STREAM_PROFILED,
            launches_per_frame_all=n_launch / STREAM_PROFILED,
            profiled_ms_per_frame=box[0] / STREAM_PROFILED,
            idle_share=1.0 - device_ms / box[0],
            max_memory_allocated=row.pop("peak"), **counts,
            launches_per_frame={k: v / row["frames"] for k, v in counts.items()},
            syncs_per_frame=statistics.mean(syncs), syncs=syncs,
            sync_sites=dict(sites.most_common()),
            ring_max=max(ring), present_equal=present_equal,
            present_max=int(st.view.framebuffer()[..., :3].max()),
            alpha_boost=r.alpha_boost)
        emit(row)
        out[mode] = row
        check(all(present_equal),
              f"{mode}: a present is not the frame drawn {lag} draws before")
        check(row["ring_max"] <= r.pipeline_depth,
              f"{mode}: the ring held {row['ring_max']} frames after a draw")
        check(row["present_max"] > 0, f"{mode}: the present is black")
        check(counts["opaque_launches"] >= row["frames"]
              and counts["shadow_launches"] >= row["frames"],
              f"{mode}: K1/K2 launched {counts} in {row['frames']} frames")
    saved = out["full_sync"]["syncs_per_frame"] - out["pipelined"]["syncs_per_frame"]
    check(saved >= STREAM_SYNCS_SAVED_MIN,
          f"the ring saves {saved} host syncs a frame, under "
          f"{STREAM_SYNCS_SAVED_MIN}")
    r.pipelined = False
    seen = capture_launches(lambda: st.push(0))
    del st, r
    torch.cuda.empty_cache()
    return out, kernels_on_largest("streamed", seen)


def kernels_on_largest(tag, seen):
    """K1 and K2 held against their plain twins on a recorded draw's
    largest launches (its primary rays and its direct-light shadow
    rays): {"k1": row, "k2": row}."""
    check(seen["trace_opaque_blocks"] and seen["trace_shadow_blocks"],
          f"{tag}: the draw launched no K1 or K2")
    return dict(k1=phase_k1(f"k1_{tag}", largest(seen["trace_opaque_blocks"])),
                k2=phase_k2(f"k2_{tag}", largest(seen["trace_shadow_blocks"])))


def edge_shift(a, b, reach=60):
    """Integer column shift s minimising mean |a[:, x + s] - b[:, x]| over
    the middle columns of two grey images."""
    import numpy as np

    h, w = a.shape
    reach = min(reach, w // 4)
    half = min(200, w // 2 - reach)
    x0, x1 = w // 2 - half, w // 2 + half
    cost = [np.abs(a[:, x0 + s : x1 + s] - b[:, x0:x1]).mean()
            for s in range(-reach, reach + 1)]
    return int(np.argmin(cost)) - reach


# Phase midframe: a yaw between two draws of bench config 3 that moves the
# picture by about MIDFRAME_SHIFT_PX display pixels; the midframe must sit
# half way, within MIDFRAME_SHIFT_TOL.
MIDFRAME_YAW = 0.03
MIDFRAME_SHIFT_TOL = 1


def phase_midframe():
    import numpy as np
    import torch
    from rt64tpu_torch import descriptors as d
    from rt64tpu_torch.utils.castle_scene import build_castle_scene
    from rt64tpu_torch.utils.ssim import ssim
    from rt64tpu_torch.utils.testscenes import build_sample_scene

    mids = {}
    for where in ("cuda", "cpu"):
        dev, _, view = build_sample_scene(160, 120, upscaler=d.UPSCALER_FSR,
                                          device=where)
        dev.draw()
        dev.draw()
        mids[where] = view._renderer.interpolated_midframe()
        render = (view._renderer._last_cfg.rt_width,
                  view._renderer._last_cfg.rt_height)
    s_small = ssim(mids["cuda"], mids["cpu"])

    (w, h), gi, refl, _ = BENCH_UPSCALED[3]
    dev, _, view = build_castle_scene(w, h, di_samples=1, gi_samples=gi)
    view.max_reflections = refl
    view.desc.upscaler = d.UPSCALER_FSR
    view.desc.upscaler_mode = d.UPSCALER_MODE_AUTO
    dev.draw()  # settles the boost ladder
    dev.draw()
    r = view._renderer
    prev = view.framebuffer()[..., :3].astype(np.float64).mean(-1)
    view.rotate_perspective(MIDFRAME_YAW, 0.0)
    dev.draw()
    cur = view.framebuffer()[..., :3].astype(np.float64).mean(-1)
    mid, mid_ms = timed(r.interpolated_midframe)
    mid_grey = mid.astype(np.float64).mean(-1)
    shift_cur, shift_mid = edge_shift(prev, cur), edge_shift(prev, mid_grey)
    cfg = r._last_cfg
    row = dict(phase="midframe", small=dict(width=160, height=120,
                                            render=render, ssim=s_small),
               config=3, display=(w, h), render=(cfg.rt_width, cfg.rt_height),
               midframe_ms=mid_ms, yaw=MIDFRAME_YAW, shift_cur_px=shift_cur,
               shift_mid_px=shift_mid, shape=tuple(mid.shape))
    emit(row)
    check(s_small >= 0.99, f"midframe SSIM card vs CPU {s_small} < 0.99")
    check(mid.shape == (h, w, 3) and mid.dtype == np.uint8,
          f"midframe {mid.shape} {mid.dtype}")
    check(abs(shift_cur) >= 8, f"the yaw moved the picture {shift_cur} px")
    check(abs(shift_mid - shift_cur / 2) <= MIDFRAME_SHIFT_TOL,
          f"midframe shift {shift_mid} px, the frames' {shift_cur} px")
    del dev, view, r
    torch.cuda.empty_cache()
    return row


# Phase banded: castle GI 1280x720 drawn whole and in 2 bands (360 rows,
# tiled) and 4 (180 rows, untiled), BAND_FRAMES frames each from zeros;
# the bounds of the JAX package's tests/test_parallel.py.
BAND_FRAMES = 3
BAND_COUNTS = (2, 4)
BAND_MEAN_TOL = 1e-6
BAND_MAX_TOL = 1e-4
# Bench config 5's native reference, as bench.py's measure_ssim draws it,
# with 4 frames a side where bench.py has 8 (the run's time limit).
NATIVE_BANDS = 4
NATIVE_BANDS_IF_OOM = 6
NATIVE_FRAMES = 4


# The moving-camera run of phase banded: the view turned in view space
# by these degrees (pitch about x, yaw about y) before each frame; the
# whole frame's flow must reach MOVE_FLOW_MIN px, vertically too (a band's
# flow y is where the row count enters).
MOVE_TURN_DEG = (1.5, 2.0)
MOVE_FLOW_MIN = 1.0


def render_timed(fn):
    """(fn(), device ms between CUDA events, peak bytes during it)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, ms = timed(fn)
    return out, ms, torch.cuda.max_memory_allocated()


def banded_frame(fn, capture_band=None):
    """fn() (a banded draw through tiling.sharded_render), with each band's
    render_frame call timed (CUDA events) and its peak memory read: (fn's
    result, band ms, band peaks, the K1 and K2 launches recorded in band
    `capture_band` (counted across fn's bands), each kind's largest only,
    or {})."""
    from rt64tpu_torch.pipeline import framegraph as fg

    original = fg.render_frame
    ms, peaks, seen = [], [], {}

    def band(*a, **kw):
        def draw():
            if len(ms) != capture_band:
                return original(*a, **kw)
            box = []
            calls = capture_launches(lambda: box.append(original(*a, **kw)))
            seen.update({k: [largest(calls[k])] if calls[k] else []
                         for k in ("trace_opaque_blocks",
                                   "trace_shadow_blocks")})
            return box[0]

        out, t, peak = render_timed(draw)
        ms.append(t)
        peaks.append(peak)
        return out

    fg.render_frame = band
    try:
        out = fn()
    finally:
        fg.render_frame = original
    return out, ms, peaks, seen


def moving_planes(out, to_img):
    """A frame's planes as images, for the moving-camera comparison."""
    g = out.gbuffers
    planes = dict(flow=to_img(g.flow), depth=to_img(g.depth))
    planes.update({f"history.{k}": to_img(v)
                   for k, v in zip(out.history._fields, out.history)})
    return out.image, to_img(g.instance), planes


def moving_band_runs(view, r, cfg, bg, edges):
    """Phase banded's moving-camera run (see MOVE_TURN_DEG) on a settled
    view: BAND_FRAMES frames drawn whole, then in each of BAND_COUNTS
    bands, the history carried on each side from zeros; edges[n]: the
    rows next to a band edge (excluded from the image only). The view's
    camera is put back after. (row, {"moving_bands<n>": K1-K4 launches})."""
    import numpy as np
    import torch
    from rt64tpu_torch.ops import math3d
    from rt64tpu_torch.ops import tracer_cuda as tc
    from rt64tpu_torch.parallel import tiling
    from rt64tpu_torch.pipeline import framegraph as fg

    vm0 = view.view_matrix.copy()
    gps = []
    for f in range(BAND_FRAMES):
        turn = np.radians(MOVE_TURN_DEG) * (f + 1)
        view.set_perspective(math3d.turn_view(vm0, *turn), view.fov_radians,
                             view.near_dist, view.far_dist)
        gps.append(r._global_params(cfg)._replace(
            frame_count=torch.tensor(f, device="cuda")))
    view.set_perspective(vm0, view.fov_radians, view.near_dist, view.far_dist)
    moved = all(not torch.equal(gp.prev_view_proj, gp.view_proj) for gp in gps)

    def frames(fn, to_img):
        hist, outs = fg.History.zeros(cfg.rt_height, cfg.rt_width, "cuda"), []
        for gp in gps:
            out = fn(r._sb, gp, hist, r.bn_table, bg)
            hist = out.history
            outs.append(moving_planes(out, to_img))
            del out
        return outs

    whole = frames(lambda sb, gp, hist, bn, bg: fg.render_frame(
        sb, gp, hist, bn, cfg, bg_planes=bg), lambda p: fg.to_image(cfg, p))
    flow_max = [float(p["flow"].abs().max()) for _, _, p in whole]
    flow_y_max = [float(p["flow"][1].abs().max()) for _, _, p in whole]
    row = dict(frames=BAND_FRAMES, turn_deg=MOVE_TURN_DEG,
               prev_view_proj_differs=moved, flow_max_px=flow_max,
               flow_y_max_px=flow_y_max)
    check(moved, "banded moving: prev_view_proj equals view_proj")
    check(min(flow_y_max) >= MOVE_FLOW_MIN,
          f"banded moving: flow y max {flow_y_max} px below {MOVE_FLOW_MIN}")
    launches = {}
    for n in BAND_COUNTS:
        tc.launch_counts.reset()
        banded = frames(tiling.sharded_render(cfg, n),
                        lambda p: tiling.to_image_banded(cfg, n, p))
        counts = launches[f"moving_bands{n}"] = dict(vars(tc.launch_counts))
        per_frame = []
        for (w_img, w_inst, w_planes), (b_img, b_inst, b_planes) in zip(
                whole, banded):
            img = (b_img - w_img).abs()[:, ~edges[n]]
            errs = {"image": (float(img.mean()), float(img.max()))}
            for k, w in w_planes.items():
                d = (b_planes[k] - w).abs()
                errs[k] = (float(d.mean()), float(d.max()))
            per_frame.append(dict(mean_max_abs=errs,
                                  instance_equal=bool(torch.equal(b_inst, w_inst))))
        row[f"bands{n}"] = dict(frames=per_frame, **counts)
        for k, fr in enumerate(per_frame):
            what = f"banded moving {n} bands frame {k}"
            for name, (mean, mx) in fr["mean_max_abs"].items():
                check(mean < BAND_MEAN_TOL and mx < BAND_MAX_TOL,
                      f"{what}: {name} mean {mean} max {mx} from the whole frame")
            check(fr["instance_equal"], f"{what}: instance planes differ")
        check(counts["opaque_launches"] >= n * BAND_FRAMES
              and counts["shadow_launches"] >= n * BAND_FRAMES,
              f"banded moving {n} bands: K1/K2 launched {counts}")
        del banded
    del whole
    return row, launches


def phase_banded_castle():
    import torch
    from rt64tpu_torch.ops import tracer_cuda as tc
    from rt64tpu_torch.parallel import tiling
    from rt64tpu_torch.pipeline import framegraph as fg
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    rows, counts_all = {}, {}
    for denoiser in (False, True):
        dev, _, view = build_castle_scene(GI_W, GI_H, di_samples=1,
                                          gi_samples=1, denoiser=denoiser)
        view.max_reflections = 0
        dev.draw()  # settles the boost ladder
        r = view._renderer
        cfg = r._last_cfg
        gp0 = r._global_params(cfg)
        bg = r._background_planes(cfg)
        row = dict(phase=f"banded_castle_gi{'_denoiser' if denoiser else ''}",
                   width=GI_W, height=GI_H, frames=BAND_FRAMES,
                   alpha_boost=r.alpha_boost, tiled_whole=cfg.tiled)
        whole, hist = [], fg.History.zeros(GI_H, GI_W, "cuda")
        for f in range(BAND_FRAMES):
            gp = gp0._replace(frame_count=torch.tensor(f, device="cuda"))
            out, ms, peak = render_timed(lambda: fg.render_frame(
                r._sb, gp, hist, r.bn_table, cfg, bg_planes=bg))
            hist = out.history
            whole.append((out.image, fg.to_image(cfg, out.gbuffers.instance),
                          int(out.alpha_dropped)))
            del out
        row.update(whole_ms=ms, whole_peak=peak)
        edges = {}
        for n in BAND_COUNTS:
            band = tiling.shard_config(cfg, n)
            render = tiling.sharded_render(cfg, n)
            edge = edges[n] = torch.zeros(GI_H, dtype=torch.bool, device="cuda")
            if denoiser:
                for b in range(1, n):
                    lo = b * band.rt_height
                    edge[lo - cfg.gi_filter_passes : lo + cfg.gi_filter_passes] = True
            hist = fg.History.zeros(GI_H, GI_W, "cuda")
            tc.launch_counts.reset()
            per_frame = []
            for f in range(BAND_FRAMES):
                gp = gp0._replace(frame_count=torch.tensor(f, device="cuda"))
                out, band_ms, band_peak, _ = banded_frame(
                    lambda: render(r._sb, gp, hist, r.bn_table, bg))
                hist = out.history
                inst = tiling.to_image_banded(cfg, n, out.gbuffers.instance)
                w_img, w_inst, w_drop = whole[f]
                diff = (out.image - w_img).abs()
                keep = diff[:, ~edge]
                per_frame.append(dict(
                    mean_abs=float(keep.mean()), max_abs=float(keep.max()),
                    edge_max_abs=float(diff[:, edge].max()) if denoiser else None,
                    instance_equal=bool(torch.equal(inst, w_inst)),
                    dropped_whole=w_drop, dropped_bands=int(out.alpha_dropped),
                    band_ms=band_ms, band_peak=band_peak))
                del out, inst, diff, keep
            counts = dict(vars(tc.launch_counts))
            counts_all[f"{'denoiser_' if denoiser else ''}bands{n}"] = counts
            row[f"bands{n}"] = dict(rows=band.rt_height, tiled=band.tiled,
                                    frames=per_frame, **counts)
            for k, fr in enumerate(per_frame):
                what = f"{row['phase']} {n} bands frame {k}"
                check(fr["mean_abs"] < BAND_MEAN_TOL and fr["max_abs"] < BAND_MAX_TOL,
                      f"{what}: mean {fr['mean_abs']} max {fr['max_abs']} "
                      "from the whole frame")
                check(fr["instance_equal"], f"{what}: instance planes differ")
                check(fr["dropped_whole"] == 0 and fr["dropped_bands"] == 0,
                      f"{what}: alpha hits dropped")
            check(counts["opaque_launches"] >= n * BAND_FRAMES
                  and counts["shadow_launches"] >= n * BAND_FRAMES,
                  f"{row['phase']} {n} bands: K1/K2 launched {counts}")
        if denoiser:
            row["moving"], moving = moving_band_runs(view, r, cfg, bg, edges)
            counts_all.update(moving)
        emit(row)
        rows[denoiser] = row
        del dev, view, r, whole, hist
        torch.cuda.empty_cache()
    return rows, counts_all


def phase_bench5_fidelity():
    """bench.py measure_ssim on bench config 5, through rt64tpu_torch.bench:
    the DLSS performance frame after NATIVE_FRAMES draws against the
    native 3840x2160 frame of bench.native_banded (bands of 3840x540,
    NATIVE_FRAMES frames, the history concatenated across the bands, at
    alpha boost 1), SSIM of the uint8 images. The alpha sweeps of the
    last DLSS draw, its alpha culls, and the K1 and K2 launches of the
    first frame's first band, are held against their plain twins: (row,
    {"k1": row, "k2": row}, the sweeps' row, the culls' row, the hit
    shader's row)."""
    import torch
    from rt64tpu_torch import bench
    from rt64tpu_torch.utils.ssim import ssim

    rung = bench.CONFIGS[5]
    w, h = rung[1], rung[2]
    dev, _, view = bench.build(*rung)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(NATIVE_FRAMES - 1):
        dev.draw()
    seen = capture_launches(dev.draw)
    dlss_s = time.perf_counter() - t0
    dlss_peak = torch.cuda.max_memory_allocated()
    prod = view.framebuffer()[..., :3].copy()
    cfg = view._renderer._last_cfg
    dlss_render = (cfg.rt_width, cfg.rt_height)
    sweep = alpha_sweep_phase("alpha_sweep_bench5", seen["alpha_sweep"])
    cull = alpha_cull_phase("alpha_cull_bench5", seen["alpha_cull"])
    shade = hit_shade_phase("hit_shade_bench5", seen["hit_shade"])
    del dev, view, cfg, seen
    torch.cuda.empty_cache()

    def native(bands):
        (image, drops), ms, peaks, seen = banded_frame(
            lambda: bench.native_banded(*rung[:6], bands, NATIVE_FRAMES),
            capture_band=0)
        return image, ms, peaks, drops, seen

    failed = None
    try:
        bands = NATIVE_BANDS
        native_img, ms, peaks, drops, seen = native(bands)
    except torch.cuda.OutOfMemoryError as exc:
        failed = str(exc).splitlines()[0]
        torch.cuda.empty_cache()
        bands = NATIVE_BANDS_IF_OOM
        native_img, ms, peaks, drops, seen = native(bands)
    s = ssim(prod, native_img)
    row = dict(phase="bench5_fidelity", config=5, display=(w, h),
               dlss_render=dlss_render, frames=NATIVE_FRAMES, ssim=s,
               native_bands=bands, native_band_rows=h // bands,
               native_oom_with_4_bands=failed,
               dlss_seconds_per_frame=dlss_s / NATIVE_FRAMES,
               dlss_peak=dlss_peak, band_ms_median=statistics.median(ms),
               band_ms=ms, band_peak_max=max(peaks),
               native_alpha_dropped=drops,
               prod_max=int(prod.max()), native_max=int(native_img.max()))
    emit(row)
    check(prod.shape == native_img.shape == (h, w, 3),
          f"bench5 frames {prod.shape} {native_img.shape}")
    check(row["prod_max"] > 0 and row["native_max"] > 0,
          "a bench5 fidelity frame is black")
    torch.cuda.empty_cache()
    return row, kernels_on_largest("native_band", seen), sweep, cull, shade


def gizmo_ring(view, light, w, h):
    """(ys, xs) of a light's gizmo ring on a w x h framebuffer and its
    distance from the eye, as api.Inspector draws it, or None off
    screen."""
    import numpy as np
    from rt64tpu_torch.ops import math3d

    proj = math3d.perspective_fov_rh(view.fov_radians, w / h, view.near_dist,
                                     view.far_dist)
    clip = math3d.transform_points_h(np.asarray(light.position, np.float32),
                                     view.view_matrix @ proj)
    if clip[3] <= 0:
        return None
    sx = int((0.5 + 0.5 * clip[0] / clip[3]) * w)
    sy = int((0.5 - 0.5 * clip[1] / clip[3]) * h)
    if not (0 <= sx < w and 0 <= sy < h):
        return None
    yy, xx = np.mgrid[-5:6, -5:6]
    ring = np.abs(np.hypot(xx, yy) - 5) < 1.0
    eye = np.linalg.inv(view.view_matrix.astype(np.float64))[3, :3]
    return (np.clip(sy + yy[ring], 0, h - 1), np.clip(sx + xx[ring], 0, w - 1),
            float(np.linalg.norm(np.asarray(light.position, np.float64) - eye)))


def phase_inspector():
    """The Inspector over castle 640x480 on the card: light gizmos (one
    light just in front of the camera, one far behind the castle), a PNG
    dump, live edits. The framebuffer before the gizmo pass is taken by
    wrapping Inspector.render."""
    import os

    import numpy as np
    import rt64tpu_torch
    from rt64tpu_torch.pipeline import framegraph as fg
    from rt64tpu_torch.utils.assets import read_image
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    w, h = CASTLE_W, CASTLE_H
    dev, scene, view = build_castle_scene(w, h, di_samples=1, gi_samples=0)
    view.max_reflections = 0
    dev.draw()
    insp = rt64tpu_torch.Inspector(dev)
    eye, fwd = view.get_view_position(), view.get_view_direction()
    offsets = (2.0, 5000.0)
    for light, dist in zip(scene.lights, offsets):
        light.position = tuple(float(v) for v in eye + fwd * dist + 0.2)
    before = []
    render = insp.render

    def hooked():
        before.append(view.framebuffer()[..., :3].copy())
        render()

    insp.render = hooked
    dump = os.path.join("build", "inspector_dump")
    replies = [insp.command("gizmos on"), insp.command(f"dump {dump}")]
    dev.draw()
    pre, after = before[-1], view.framebuffer()[..., :3].copy()
    png = read_image(os.path.join(dump, "frame_00000.png"))
    pick, cfg = view._renderer._pick_src
    pos = fg.to_image(cfg, pick.position).cpu().numpy().transpose(1, 2, 0)
    inst = fg.to_image(cfg, pick.instance).cpu().numpy()
    eye64 = np.linalg.inv(view.view_matrix.astype(np.float64))[3, :3]
    hit = np.where(inst >= 0, np.linalg.norm(pos - eye64, axis=-1), np.inf)
    rings = dict(on_screen=0, pixels=0, occluded=0, occluded_even_unchanged=True,
                 open_pixels_coloured=True)
    for light in scene.lights[: len(offsets)]:
        ring = gizmo_ring(view, light, w, h)
        if ring is None:
            continue
        ys, xs, dist = ring
        colour = np.clip(np.asarray(light.diffuse_color) * 255 + 64, 0,
                         255).astype(np.uint8)
        occ = hit[ys * cfg.rt_height // h, xs * cfg.rt_width // w] < dist
        even = (ys + xs) % 2 == 0
        rings["on_screen"] += 1
        rings["pixels"] += len(ys)
        rings["occluded"] += int(occ.sum())
        rings["occluded_even_unchanged"] &= bool(
            (pre[ys, xs][occ & even] == after[ys, xs][occ & even]).all())
        rings["open_pixels_coloured"] &= bool(
            (after[ys, xs][~occ] == colour).all())
    replies += [insp.command("dump off"), insp.command("gizmos off"),
                insp.command("set view.upscaler_sharpness 0.5"),
                insp.command("get view.upscaler_sharpness"),
                insp.command("camera rotate 0.1 0")]
    dev.draw()
    row = dict(phase="inspector", width=w, height=h, replies=replies,
               rings=rings,
               changed_pixels=int((pre != after).any(-1).sum()),
               dump_equal=bool(np.array_equal(png[..., :3], after)
                               and (png[..., 3] == 255).all()),
               next_draw_differs=bool((view.framebuffer()[..., :3] != after).any()))
    emit(row)
    check(rings["on_screen"] == 2 and rings["pixels"] > 0,
          f"gizmo rings on screen: {rings}")
    check(rings["occluded"] > 0 and rings["occluded"] < rings["pixels"],
          f"the rings' occlusion does not vary: {rings}")
    check(rings["occluded_even_unchanged"] and rings["open_pixels_coloured"],
          f"the gizmo pass broke the occlusion dither: {rings}")
    check(row["dump_equal"], "the dumped PNG is not the framebuffer")
    check(replies == ["OK", "OK", "OK", "OK", "OK", "0.5", "OK"],
          f"inspector replies {replies}")
    check(row["next_draw_differs"], "the edits did not change the next draw")
    return row


# Phase abi: the sample hosts at the size they draw by default.
ABI_W, ABI_H = 320, 240
ABI_SSIM_MIN = 0.99
JAX_SAMPLE_PPM = "rt64tpu/abi/sample_host.ppm"


def phase_abi():
    """The C ABI on the card: librt64tpu_torch.so and both sample hosts
    built with g++ (abi/build.py), each host run in a subprocess at
    320x240 on the card; each PPM held against the same calls replayed in
    Python through the port's bridge, in this process, with every
    DrawDevice made through the library's RT64_DrawDevice (loaded with
    ctypes: the shim finds this interpreter running and forwards to the
    same bridge), the launch counts set to 0 just before and read just
    after; then the same replays in turns with each draw a direct
    Device.draw(), through the ABI, and direct again, for the ms of each
    draw both ways (host clock; a draw ends in its present readback).
    The SSIM against the JAX package's checked-in sample_host.ppm (origin
    not recorded) is printed."""
    import ctypes
    import os

    import numpy as np
    from rt64tpu_torch.abi import bridge, hosts
    from rt64tpu_torch.abi import build as abi_build
    from rt64tpu_torch.ops import tracer_cuda as tc
    from rt64tpu_torch.utils.assets import read_ppm
    from rt64tpu_torch.utils.ssim import ssim

    t0 = time.perf_counter()
    built = abi_build.build()
    build_s = time.perf_counter() - t0
    os.environ.pop(bridge.DEVICE_ENV, None)  # the hosts draw on the card
    runs = {}
    for name, env in (("sample_host", {}),
                      ("sample_host_dl", {"RT64TPU_LIBRARY": built.library})):
        ppm = os.path.join(built.directory, f"{name}.ppm")
        if os.path.exists(ppm):
            os.remove(ppm)
        t0 = time.perf_counter()
        run = abi_build.run_host(getattr(built, name), ppm, ABI_W, ABI_H, env)
        runs[name] = dict(rc=run.returncode, seconds=time.perf_counter() - t0,
                          stdout=run.stdout.strip().splitlines(),
                          stderr_tail=run.stderr[-2000:])
        check(run.returncode == 0,
              f"{name} exited {run.returncode}: {run.stderr[-2000:]}")
        check(os.path.exists(ppm), f"{name} wrote no PPM")
        runs[name]["ppm"] = read_ppm(ppm)
    check("picked instance at center: sphere" in runs["sample_host"]["stdout"],
          f"sample_host picked {runs['sample_host']['stdout']}")

    lib = ctypes.CDLL(built.library)
    lib.RT64_DrawDevice.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
    lib.RT64_DrawDevice.restype = None
    lib.RT64_GetLastError.restype = ctypes.c_char_p

    def timed_draw(fn, ms):
        def draw(device):
            t0 = time.perf_counter()
            fn(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        return draw

    draws = dict(
        abi=lambda dev: lib.RT64_DrawDevice(dev, 1, hosts.DELTA_MS),
        device=lambda dev: bridge._get(dev).draw(1, float(hosts.DELTA_MS)))
    ms = {name: {way: [] for way in draws} for name in ("sample_host",
                                                        "sample_host_dl")}
    saved = {k: os.environ.get(k) for k in ("RT64TPU_VIEW_WIDTH",
                                            "RT64TPU_VIEW_HEIGHT")}
    os.environ.update(RT64TPU_VIEW_WIDTH=str(ABI_W), RT64TPU_VIEW_HEIGHT=str(ABI_H))
    try:
        # The replays held against the hosts, through the C ABI, counted.
        tc.launch_counts.reset()
        replay, pick = hosts.sample_host(bridge, draw=timed_draw(
            draws["abi"], ms["sample_host"]["abi"]))
        counts = {"sample_host": dict(vars(tc.launch_counts))}
        tc.launch_counts.reset()
        replay_dl = hosts.sample_host_dl(bridge, draw=timed_draw(
            draws["abi"], ms["sample_host_dl"]["abi"]))
        counts["sample_host_dl"] = dict(vars(tc.launch_counts))
        error = lib.RT64_GetLastError().decode()
        # Then in turns, warm: Device.draw(), the ABI, Device.draw().
        for way in ("device", "abi", "device"):
            hosts.sample_host(bridge, draw=timed_draw(
                draws[way], ms["sample_host"][way]))
            hosts.sample_host_dl(bridge, draw=timed_draw(
                draws[way], ms["sample_host_dl"][way]))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    frames = {"sample_host": replay[..., :3], "sample_host_dl": replay_dl[..., :3]}
    row = dict(phase="abi", width=ABI_W, height=ABI_H, build_seconds=build_s,
               library=built.library, rt64_last_error=error, pick=pick,
               launches=counts, draw_ms=ms)
    for name, frame in frames.items():
        ppm = runs[name].pop("ppm")
        runs[name].update(
            ssim_vs_replay=ssim(ppm, frame),
            max_abs_vs_replay=int(np.abs(ppm.astype(int) - frame).max()),
            equal_to_replay=bool(np.array_equal(ppm, frame)))
        if name == "sample_host":
            jax_ppm = read_ppm(JAX_SAMPLE_PPM)
            runs[name]["ssim_vs_jax_ppm"] = ssim(ppm, jax_ppm)
    row["hosts"] = runs
    emit(row)
    check(error == "", f"the C ABI reported: {error}")
    check(pick == "sphere", f"the replay picked {pick}")
    for name, run in runs.items():
        check(run["ssim_vs_replay"] >= ABI_SSIM_MIN,
              f"{name}: SSIM {run['ssim_vs_replay']} against its replay")
        c, frames = counts[name], (3 if name == "sample_host" else 1)
        check(c["opaque_launches"] >= frames and c["shadow_launches"] >= frames,
              f"{name} through the C ABI launched K1/K2 {c}")
    return row


DDS_W, DDS_H = 160, 120
DDS_FORMATS = ((b"DXT1", False), (b"DXT3", None), (b"DXT5", None))


def phase_dds():
    """A BC1 (opaque blocks), a BC2 and a BC3 texture of random blocks made
    from a seed with numpy, decoded on the host, on the sample scene's
    sphere at 160x120 (no GI, no reflections): two draws on the card
    against the CPU, SSIM >= 0.99."""
    from rt64tpu_torch.utils.assets import decode_dds
    from rt64tpu_torch.utils.testscenes import (build_sample_scene,
                                                dds_file, dds_texture)

    rows = []
    for seed, (fourcc, punch) in enumerate(DDS_FORMATS):
        data = dds_file(fourcc, 256, 256, seed, punch)
        t0 = time.perf_counter()
        decode_dds(data)
        decode_ms = (time.perf_counter() - t0) * 1e3

        def textured(where):
            dev, scene, view = build_sample_scene(DDS_W, DDS_H, gi_samples=0,
                                                  device=where)
            view.max_reflections = 0
            sphere = scene.instances[0]
            sphere.desc.diffuse_texture = dds_texture(dev, fourcc, 256, seed,
                                                      punch)
            sphere.set_description(sphere.desc)
            return dev, scene, view

        s, counts, seconds = card_vs_cpu(textured, 2)
        row = dict(phase="dds", format=fourcc.decode(), size=256,
                   decode_ms_256=decode_ms, width=DDS_W, height=DDS_H,
                   ssim=s, seconds=seconds, **counts)
        emit(row)
        rows.append(row)
        check(s >= 0.99, f"{fourcc.decode()} texture SSIM card vs CPU {s} < 0.99")
        check(counts["opaque_launches"] >= 2 and counts["shadow_launches"] >= 2,
              f"the {fourcc.decode()} frames launched K1/K2 {counts}")
    return rows


# Phase train: the JAX trainer's sizes, 2 pairs of each scene kind.
TRAIN_PAIRS = 2
TRAIN_STEPS = 50
TRAIN_LOSS_TOL = 1e-5  # card against CPU at step 0 (the CPU test's)


def phase_train():
    """The upscaler trainer on the card: render_pairs at lo 96x128, hi
    192x256, TRAIN_PAIRS each of the sample scene, the castle and the
    castle with GI (the launch counts set to 0 just before and read just
    after), the last pair of each kind held out; a fresh net, the step-0
    loss on the card against the CPU from the same weights; TRAIN_STEPS
    steps of train_upscaler.fit (ms per step between CUDA events), whose
    net takes nothing from the flow channels; held-out SSIM of the net,
    the bilinear upscale and the shipped weights. The weights are written
    under build/."""
    import os

    import numpy as np
    import torch
    from rt64tpu_torch.models import learned_upscaler as lu
    from rt64tpu_torch.models import train_upscaler as tr
    from rt64tpu_torch.ops import tracer_cuda as tc

    tc.launch_counts.reset()
    t0 = time.perf_counter()
    batch, kinds = tr.corpus(TRAIN_PAIRS, device="cuda")
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    counts = dict(vars(tc.launch_counts))
    heldout = tr.hold_out(batch, kinds)
    dh, dw = batch[0][1].shape[1:]
    lo = batch[0][0]["rt_color"].shape[1:]

    net = tr.fresh_net(0, "cuda")
    cpu_net = tr.fresh_net(0, "cpu")
    with torch.no_grad():
        cpu_loss0 = float(tr.loss_fn(cpu_net, *tr.stack_batch(batch, "cpu"),
                                     dh, dw))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # fit's batch upload and its one sync (zero_unseen_inputs) count in
    # the steps' time.
    start.record()
    losses = tr.fit(net, batch, TRAIN_STEPS, 1e-3, "cuda")
    end.record()
    torch.cuda.synchronize()
    losses = [float(v) for v in losses]
    flow_weights = float(net.convs[0].weight[:, 4:6].abs().max())
    s_net, s_bil = tr.evaluate(net, heldout, dh, dw, "cuda")
    s_shipped, _ = tr.evaluate(lu.get_net(torch.device("cuda")), heldout, dh,
                               dw, "cuda")
    out = os.path.join("build", "train_upscaler", "params.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    lu.save_params(out, net)
    row = dict(phase="train", low=tuple(lo), high=(dh, dw), kinds=kinds,
               train_pairs=len(batch), heldout_pairs=len(heldout),
               render_seconds=render_s, steps=TRAIN_STEPS,
               ms_per_step=start.elapsed_time(end) / TRAIN_STEPS,
               loss_first=losses[0], loss_last=losses[-1],
               loss_every_10=losses[::10], cpu_loss_step0=cpu_loss0,
               heldout_ssim_net=s_net, heldout_ssim_bilinear=s_bil,
               heldout_ssim_shipped=s_shipped, conv0_flow_weight_max=flow_weights,
               weights=out, **counts)
    emit(row)
    check(tuple(lo) == (96, 128) and (dh, dw) == (192, 256),
          f"training pairs {lo} -> {(dh, dw)}")
    check(all(np.isfinite(losses)), f"a training loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    check(flow_weights == 0.0,
          f"Conv_0 takes {flow_weights} from the cut pairs' zero flow")
    check(abs(losses[0] - cpu_loss0) <= TRAIN_LOSS_TOL,
          f"step-0 loss card {losses[0]} CPU {cpu_loss0}")
    check(counts["opaque_launches"] >= 2 * 3 * TRAIN_PAIRS
          and counts["shadow_launches"] >= 2 * 3 * TRAIN_PAIRS,
          f"render_pairs launched K1/K2 {counts}")
    return row


def phase_bench():
    """python3 -m rt64tpu_torch.bench --config 1 with few frames: its JSON
    line must parse and carry bench.py's keys and the card."""
    import contextlib
    import io

    from rt64tpu_torch import bench
    from rt64tpu_torch.ops import tracer_cuda as tc

    out = io.StringIO()
    tc.launch_counts.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        bench.main(["--config", "1", "--frames", "8", "--reps", "2"])
    seconds = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1])
    row = dict(phase="bench", config=1, seconds=seconds, line=line,
               **vars(tc.launch_counts))
    emit(row)
    check(len(lines) == 1, f"the bench printed {len(lines)} lines")
    check({"metric", "value", "unit", "vs_baseline", "card"} <= set(line)
          and line["value"] > 0 and line["unit"] == "frames/sec",
          f"the bench line {line}")
    check(row["opaque_launches"] >= 8 and row["shadow_launches"] >= 8,
          f"the bench launched K1/K2 {vars(tc.launch_counts)}")
    return row


def band_launches(counts, key):
    return {run: c[key] for run, c in counts.items()}


def result_line():
    import torch

    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def run(args):
    if args:
        print(f"chip_smoke: unknown arguments {args}; run it with none",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from rt64tpu_torch.ops import tracer_cuda as tc
        from rt64tpu_torch.utils.castle_scene import build_castle_scene
    except ImportError as exc:
        print(f"chip_smoke: rt64tpu_torch not importable ({exc}); run it "
              "from the repository root", file=sys.stderr)
        return 1

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(dict(phase="card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda,
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32))

    # 2. build
    t0 = time.perf_counter()
    lib = tc.kernel_library()
    ptxas = [l.strip() for l in lib.ptxas_log.splitlines()
             if "registers" in l or "spill" in l]
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=lib.build_seconds, library=lib.path, ptxas=ptxas))

    # 3-4. K1 and K2 on the castle frame's own launches
    dev, _, view = build_castle_scene(CASTLE_W, CASTLE_H, di_samples=1,
                                      gi_samples=0)
    view.max_reflections = 0
    dev.draw()  # settles the alpha boost ladder
    seen = capture_launches(dev.draw)
    check(seen["trace_opaque_blocks"] and seen["trace_shadow_blocks"],
          "the castle frame launched no K1 or K2")
    k1 = phase_k1("k1", seen["trace_opaque_blocks"][-1])
    k2 = phase_k2("k2", seen["trace_shadow_blocks"][-1])
    # 4b. the alpha sweep's kernel on every sweep of that frame; 4b'. the
    # alpha cull's on every cull; 4c. the hit shader's on every shade_hits
    # call
    sweep = alpha_sweep_phase("alpha_sweep", seen["alpha_sweep"])
    cull = alpha_cull_phase("alpha_cull", seen["alpha_cull"])
    shade = hit_shade_phase("hit_shade", seen["hit_shade"])
    del dev, view, seen
    torch.cuda.empty_cache()

    # 5. main path
    main = phase_main_path()

    # 6. sample scene, card vs CPU
    phase_sample()

    # 6b. K1 and K2 on a castle GI frame's bounce launches
    k1["bounce"], k2["bounce"], plain_fb = phase_k1_k2_bounce()

    # 6c. the castle GI frame with two reflection bounces (bench config
    # 4), and K1 on its reflection launches
    refl, seen = phase_reflections(plain_fb)
    k1["reflection"] = phase_k1_reflections(seen)
    del seen, plain_fb
    torch.cuda.empty_cache()

    # 6d. the castle-raster frame (raster skybox and HUD over bench
    # config 4's ray mix), and the debug views of its outputs
    raster, dev, view = phase_raster()
    phase_debug_views(dev, view)
    del dev, view
    torch.cuda.empty_cache()

    # 7-8. K3 and K4 on a large-castle GI frame's own launches
    dev, view = build_large_castle()
    dev.draw()  # settles the alpha boost ladder, fills the history
    seen = capture_launches(dev.draw)
    # 9b's draw: the same scene with two reflection bounces
    view.max_reflections = REFL_BOUNCES
    refl_seen = capture_launches(dev.draw)
    del dev, view
    k3 = phase_k3(seen)
    k4 = phase_k4(seen)
    del seen
    k3["reflection"] = phase_k3_reflection(refl_seen)
    del refl_seen
    torch.cuda.empty_cache()

    # 9. the large-scene GI path
    large = phase_large_gi()
    torch.cuda.empty_cache()

    # 10. GI through K1/K2, card vs CPU
    phase_gi_small()

    # 11. reflections and refraction, card vs CPU; mip LOD on the card
    phase_secondary_small()
    phase_mip_lod()

    # 12. the golden frame on the card; raster layers card vs CPU
    phase_golden()
    phase_raster_small()

    # 13. bench configs 2-4 as written (FSR auto); 14. every upscaler
    # slot, RCAS and motion blur card vs CPU
    upscaled = phase_upscaled()
    phase_upscalers_small()

    # 15. bench.py's streamed loop on bench config 4, full sync and
    # pipelined; 16. the midframe; 17. banded frames, and bench config
    # 5's fidelity against its banded native reference; 18. the Inspector
    streamed, k_streamed = phase_streamed()
    phase_midframe()
    _, banded_counts = phase_banded_castle()
    (_, k_native, sweep["bench5"], cull["bench5"],
     shade["bench5"]) = phase_bench5_fidelity()
    phase_inspector()

    # 19. the C ABI: both sample hosts on the card; 20. DDS textures;
    # 21. the upscaler trainer; 22. the bench module
    abi = phase_abi()
    phase_dds()
    train = phase_train()
    phase_bench()
    for tag, rows in (("streamed", k_streamed), ("native_band", k_native)):
        k1[tag], k2[tag] = rows["k1"], rows["k2"]

    measured = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    # Every kernel also carries its bounce launch's numbers, as
    # bounce_<key>. Every number of this line but bound_ms was measured in
    # this run.
    # K1 and K3 also carry their first reflection launch's, as
    # reflection_<key>, with the launches of the path that ran them: the
    # 10 castle-refl frames (K1), the recorded large-castle-refl draw (K3).
    # K1 and K2 also carry their launches in the 10 castle-raster frames,
    # as raster_launches, in the frames of each upscaled bench config, as
    # upscaled_launches, in the timed frames of each mode of the streamed
    # loop, as streamed_launches, in each banded run of the castle GI
    # frame (denoiser off and on, 2 and 4 bands, and the moving camera
    # with the denoiser), as banded_launches, in
    # each sample host's calls made through the C ABI, as abi_launches, and
    # in the trainer's render_pairs, as train_launches.
    # K1 and K2 also carry the numbers of their largest launches in one
    # streamed config-4 frame, as streamed_<key>, and in the first band
    # of bench config 5's native reference, as native_band_<key>.
    # The alpha sweep's kernel has no bounce launch: its row's numbers
    # are sums over the sweeps of one castle frame (4b), and over those of
    # one settled bench config 5 draw as bench5_<key>, with the launches
    # of each draw; it carries its launches in the same paths as K1. So
    # does the hit shader's kernel, over the shade_hits calls (4c), and the
    # alpha cull's, over the culls (4b').
    kernel = lambda name, src, line, launches, row, refl_launches=None, **more: dict(
        name=name, route="cuda", source=f"rt64tpu_torch/csrc/{src}",
        replaces=f"rt64tpu/ops/tracer_pallas.py:{line}", launches=launches,
        **{k: row[k] for k in measured}, library_ms=None,
        **{f"bounce_{k}": row["bounce"][k] for k in measured},
        **({} if refl_launches is None else dict(
            reflection_launches=refl_launches,
            **{f"reflection_{k}": row["reflection"][k] for k in measured})),
        **{f"{tag}_{k}": row[tag][k] for tag in ("streamed", "native_band")
           if tag in row for k in measured},
        **more)
    emit({"kernels": [
        kernel("trace_opaque_walk<WoopClusters> (K1)", "packet_tracer.cu",
               764, main["opaque_launches"], k1, refl["opaque_launches"],
               raster_launches=raster["opaque_launches"],
               upscaled_launches={f"bench{n}": row["opaque_launches"]
                                  for n, row in upscaled.items()},
               streamed_launches={m: row["opaque_launches"]
                                  for m, row in streamed.items()},
               banded_launches=band_launches(banded_counts, "opaque_launches"),
               abi_launches={h: c["opaque_launches"]
                             for h, c in abi["launches"].items()},
               train_launches=train["opaque_launches"]),
        kernel("trace_shadow_walk<WoopClusters> (K2)", "packet_tracer.cu",
               981, main["shadow_launches"], k2,
               raster_launches=raster["shadow_launches"],
               upscaled_launches={f"bench{n}": row["shadow_launches"]
                                  for n, row in upscaled.items()},
               streamed_launches={m: row["shadow_launches"]
                                  for m, row in streamed.items()},
               banded_launches=band_launches(banded_counts, "shadow_launches"),
               abi_launches={h: c["shadow_launches"]
                             for h, c in abi["launches"].items()},
               train_launches=train["shadow_launches"]),
        kernel("trace_opaque_walk<MtClusters> (K3)", "mt_tracer.cu", 572,
               large["opaque_mt_launches"], k3,
               k3["reflection"]["launches_per_frame"]),
        kernel("trace_shadow_walk<MtClusters> (K4)", "mt_tracer.cu", 1303,
               large["shadow_mt_launches"], k4),
        dict(name="alpha_sweep_kernel<K, CULL>", route="cuda",
             source="rt64tpu_torch/csrc/alpha_sweep.cu", replaces=None,
             launches=main["alpha_sweep_launches"],
             **{k: sweep[k] for k in measured}, library_ms=None,
             launches_per_draw=sweep["launches"],
             **{f"bench5_{k}": sweep["bench5"][k] for k in measured},
             bench5_launches_per_draw=sweep["bench5"]["launches"],
             reflection_launches=refl["alpha_sweep_launches"],
             raster_launches=raster["alpha_sweep_launches"],
             upscaled_launches={f"bench{n}": row["alpha_sweep_launches"]
                                for n, row in upscaled.items()},
             streamed_launches={m: row["alpha_sweep_launches"]
                                for m, row in streamed.items()},
             banded_launches=band_launches(banded_counts,
                                           "alpha_sweep_launches"),
             abi_launches={h: c["alpha_sweep_launches"]
                           for h, c in abi["launches"].items()},
             train_launches=train["alpha_sweep_launches"]),
        dict(name="alpha_cull_kernel", route="cuda",
             source="rt64tpu_torch/csrc/alpha_cull.cu", replaces=None,
             launches=main["alpha_cull_launches"],
             **{k: cull[k] for k in measured}, library_ms=None,
             launches_per_draw=cull["launches"],
             **{f"bench5_{k}": cull["bench5"][k] for k in measured},
             bench5_launches_per_draw=cull["bench5"]["launches"],
             reflection_launches=refl["alpha_cull_launches"],
             raster_launches=raster["alpha_cull_launches"],
             upscaled_launches={f"bench{n}": row["alpha_cull_launches"]
                                for n, row in upscaled.items()},
             streamed_launches={m: row["alpha_cull_launches"]
                                for m, row in streamed.items()},
             banded_launches=band_launches(banded_counts,
                                           "alpha_cull_launches"),
             abi_launches={h: c["alpha_cull_launches"]
                           for h, c in abi["launches"].items()},
             train_launches=train["alpha_cull_launches"]),
        dict(name="hit_shade_kernel<SHADOW, TEXEL1, NMAP, SMAP, MIPS>",
             route="cuda", source="rt64tpu_torch/csrc/hit_shade.cu",
             replaces=None, launches=main["hit_shade_launches"],
             **{k: shade[k] for k in measured}, library_ms=None,
             calls_per_draw=shade["calls"],
             **{f"bench5_{k}": shade["bench5"][k] for k in measured},
             bench5_calls_per_draw=shade["bench5"]["calls"],
             reflection_launches=refl["hit_shade_launches"],
             raster_launches=raster["hit_shade_launches"],
             upscaled_launches={f"bench{n}": row["hit_shade_launches"]
                                for n, row in upscaled.items()},
             streamed_launches={m: row["hit_shade_launches"]
                                for m, row in streamed.items()},
             banded_launches=band_launches(banded_counts,
                                           "hit_shade_launches"),
             abi_launches={h: c["hit_shade_launches"]
                           for h, c in abi["launches"].items()},
             train_launches=train["hit_shade_launches"]),
    ]})
    result_line()
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
