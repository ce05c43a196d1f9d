"""Kernels, K4 (csrc/mt_tracer.cu, trace_shadow_walk<MtClusters>): the
share (%) of its roofline that the frame's direct-light occlusion launch
reaches, summed over the profiled frames: (least time) / (kernel time).

K2's reader (kernels.k2_shadow_roofline.py) for the Moller-Trumbore
layout, which scenes past the size switch trace: a copy of that module
of its own, with the walk named as the trace names K4's. The work is
counted from the inputs by K2's functions (the reference's hit share
times the render size times di_samples shadow rays), so the same work
reads the same whatever table traces it. The launch is the frame's first
walk of this layout (the direct-light launch comes before any
bounce's).
"""

import os

from portbench.harness import Benchmark

UNIT = "%"
WALK = ("trace_shadow_walk<", "MtClusters")  # as the trace names it


# K2's reader, loaded anew by the harness's own lookup: a module of its
# own, whose launch_us finds K4's name.
_K2 = Benchmark(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), spec={}).reader("kernels.k2_shadow_roofline")
_K2.WALK = WALK
work, launch_us, read = _K2.work, _K2.launch_us, _K2.read
