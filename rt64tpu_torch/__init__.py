"""rt64tpu_torch — the PyTorch/CUDA port of rt64tpu.

A second package beside the JAX one (which stays the reference): the
same RT64 object model, scene packing and frame graph as plain torch on
explicit devices, with the packet-traversal kernels written by hand in
CUDA C++ for Hopper (``csrc/``: one walk, ``packet_walk.cuh``, over the
Woop table in ``packet_tracer.cu`` and the Moller-Trumbore table in
``mt_tracer.cu``). A Device renders on the
CUDA card unless the caller passes ``device="cpu"``; CPU tensors take
each kernel's plain-torch twin.

The port imports neither JAX nor the rt64tpu package.
"""

from rt64tpu_torch.descriptors import (  # noqa: F401
    Material,
    Light,
    SceneDesc,
    ViewDesc,
    InstanceDesc,
    TextureDesc,
    apply_material_attributes,
)
from rt64tpu_torch.api import (  # noqa: F401
    Device,
    Scene,
    View,
    Mesh,
    Texture,
    Shader,
    Instance,
    Inspector,
)

__version__ = "0.1.0"
