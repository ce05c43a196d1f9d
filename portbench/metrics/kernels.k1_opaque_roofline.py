"""Kernels, K1 (csrc/packet_tracer.cu, trace_opaque_walk<WoopClusters>):
the share (%) of its roofline that the frame's primary closest-hit
launch reaches, summed over the profiled frames: (least time) / (kernel
time).

The work is counted from the inputs, whatever implements them: the
render size's camera rays (one per pixel), each read once (origin,
direction, t_min, t_max: 32 bytes), the scene's triangles read once in
the benchmark's own layout (three float32 vertices: 36 bytes), one hit
written per ray (t, triangle, u, v: 16 bytes), and one ray-triangle test
per ray (the test of its hit: OPS_PER_TEST float32 operations). The
least time is the larger of the operations over the card's float32 peak
and the bytes over its memory bandwidth (peaks.json). The kernel time
is that of the launch's kernels as the trace names them: the walk, the
prologue just before it and the finalize just after it. The launch is
the frame's first walk of this layout (the primary pass traces first).
"""

UNIT = "%"
# Names as the trace gives them, e.g. "void (anonymous namespace)::
# trace_opaque_walk<(anonymous namespace)::WoopClusters, false, true>(...)".
WALK = ("trace_opaque_walk<", "WoopClusters")
PROLOGUE = "prologue_kernel("
FINALIZE = ("finalize_kernel<", "WoopClusters")
RAY_BYTES = 32
TRIANGLE_BYTES = 36
HIT_BYTES = 16
# Moller-Trumbore: two cross products (12), three dot products and the
# determinant's (16), the origin offset (3), the reciprocal and three
# scalings (4), the bounds tests (5).
OPS_PER_TEST = 40


def work(rays: int, triangles: int):
    """(float32 operations, bytes) these inputs need."""
    return (rays * OPS_PER_TEST,
            rays * (RAY_BYTES + HIT_BYTES) + triangles * TRIANGLE_BYTES)


def least_s(ops: float, nbytes: float, peaks: dict) -> float:
    return max(ops / peaks["fp32_flops_per_s"],
               nbytes / peaks["memory_bytes_per_s"])


def launch_us(kernels):
    """Kernel time of the first launch in a frame's kernels, or None."""
    for i, (name, a, b) in enumerate(kernels):
        if all(w in name for w in WALK):
            t = b - a
            for pname, pa, pb in reversed(kernels[:i]):
                if PROLOGUE in pname:
                    t += pb - pa
                    break
            for fname, fa, fb in kernels[i + 1:]:
                if all(w in fname for w in FINALIZE):
                    t += fb - fa
                    break
            return t
    return None


def read(td):
    if td.peaks is None:
        return None
    rw, rh = td.cfg["render"]
    ops, nbytes = work(rw * rh, td.triangles)
    least = kernel = 0.0
    for ks in td.frame_kernels():
        t = launch_us(ks)
        if t is not None:
            least += least_s(ops, nbytes, td.peaks)
            kernel += t / 1e6
    return 100.0 * least / kernel if kernel > 0 else None
