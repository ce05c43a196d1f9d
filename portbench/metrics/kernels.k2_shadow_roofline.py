"""Kernels, K2 (csrc/packet_tracer.cu, trace_shadow_walk<WoopClusters>):
the share (%) of its roofline that the frame's direct-light occlusion
launch reaches, summed over the profiled frames: (least time) / (kernel
time).

The work is counted from the inputs, whatever implements them: one
shadow ray per render pixel that the reference sees hit geometry, per
direct-light sample (the least a pixel needs: the reference's hit share
of its sampled pixels times the render size times di_samples), each
read once (32 bytes), the scene's triangles read once in the
benchmark's own layout (36 bytes), one occlusion flag written per ray
(4 bytes), and one ray-triangle test per ray (OPS_PER_TEST float32
operations). The least time is the larger of the operations over the
card's float32 peak and the bytes over its memory bandwidth
(peaks.json). The kernel time is that of the walk and the prologue just
before it, for the frame's first walk of this layout (the direct-light
launch comes before any bounce's).
"""

UNIT = "%"
WALK = ("trace_shadow_walk<", "WoopClusters")  # as the trace names it
PROLOGUE = "prologue_kernel("
RAY_BYTES = 32
TRIANGLE_BYTES = 36
FLAG_BYTES = 4
OPS_PER_TEST = 40  # as the closest-hit test: see kernels.k1_opaque_roofline


def work(rays: int, triangles: int):
    """(float32 operations, bytes) these inputs need."""
    return (rays * OPS_PER_TEST,
            rays * (RAY_BYTES + FLAG_BYTES) + triangles * TRIANGLE_BYTES)


def launch_us(kernels):
    for i, (name, a, b) in enumerate(kernels):
        if all(w in name for w in WALK):
            t = b - a
            for pname, pa, pb in reversed(kernels[:i]):
                if PROLOGUE in pname:
                    t += pb - pa
                    break
            return t
    return None


def read(td):
    if td.peaks is None or not td.hit_share:
        return None
    rw, rh = td.cfg["render"]
    rays = int(round(td.hit_share * rw * rh)) * int(td.cfg["di_samples"])
    ops, nbytes = work(rays, td.triangles)
    least_each = max(ops / td.peaks["fp32_flops_per_s"],
                     nbytes / td.peaks["memory_bytes_per_s"])
    least = kernel = 0.0
    for ks in td.frame_kernels():
        t = launch_us(ks)
        if t is not None:
            least += least_each
            kernel += t / 1e6
    return 100.0 * least / kernel if kernel > 0 else None
