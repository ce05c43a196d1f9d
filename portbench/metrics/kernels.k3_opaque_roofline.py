"""Kernels, K3 (csrc/mt_tracer.cu, trace_opaque_walk<MtClusters>): the
share (%) of its roofline that the frame's primary closest-hit launch
reaches, summed over the profiled frames: (least time) / (kernel time).

K1's reader (kernels.k1_opaque_roofline.py) for the Moller-Trumbore
layout, which scenes past the size switch trace: a copy of that module
of its own, with the walk and the finalize named as the trace names
K3's. The work is counted from the inputs by K1's functions, so the same
work reads the same whatever table traces it; the prologue is the one
before the walk, as there. The launch is the frame's first walk of this
layout (the primary pass traces first).
"""

import os

from portbench.harness import Benchmark

UNIT = "%"
# e.g. "void (anonymous namespace)::trace_opaque_walk<(anonymous
# namespace)::MtClusters, false, true>(...)".
WALK = ("trace_opaque_walk<", "MtClusters")
FINALIZE = ("finalize_kernel<", "MtClusters")


# K1's reader, loaded anew by the harness's own lookup: a module of its
# own, whose launch_us finds K3's names.
_K1 = Benchmark(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), spec={}).reader("kernels.k1_opaque_roofline")
_K1.WALK, _K1.FINALIZE = WALK, FINALIZE
work, least_s, launch_us, read = _K1.work, _K1.least_s, _K1.launch_us, _K1.read
