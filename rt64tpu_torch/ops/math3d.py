"""Vector/matrix math in the reference's row-vector convention.

The reference uses DirectXMath row-major, row-vector matrices: points
transform as ``[x y z 1] @ M`` and translations live in ``M[3, :3]``
(see sample main.cpp:244-258, rt64_view.cpp:1759-1766). These helpers
are host-side NumPy: they build the per-frame camera and transforms
before anything is uploaded to the device.
"""

from __future__ import annotations

import math

import numpy as np


def transform_points(points, m):
    """``[p, 1] @ M`` -> xyz. points: (..., 3), m: (..., 4, 4)."""
    return points @ m[..., :3, :3] + m[..., 3, :3]


def transform_points_h(points, m):
    """``[p, 1] @ M`` -> xyzw (homogeneous). points: (..., 3)."""
    return points @ m[..., :3, :4] + m[..., 3, :4]


def transform_dirs(dirs, m):
    """``[d, 0] @ M`` -> xyz (no translation)."""
    return dirs @ m[..., :3, :3]


def perspective_fov_rh(fov_radians: float, aspect: float, near: float, far: float):
    """XMMatrixPerspectiveFovRH, row-vector convention (rt64_view.cpp:1766)."""
    h = 1.0 / math.tan(fov_radians * 0.5)
    w = h / aspect
    rng = far / (near - far)
    return np.array(
        [
            [w, 0.0, 0.0, 0.0],
            [0.0, h, 0.0, 0.0],
            [0.0, 0.0, rng, -1.0],
            [0.0, 0.0, rng * near, 0.0],
        ],
        dtype=np.float32,
    )


def look_at_rh(eye, target, up):
    """XMMatrixLookAtRH, row-vector convention (view matrix)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[3, 0] = -float(np.dot(x, eye))
    m[3, 1] = -float(np.dot(y, eye))
    m[3, 2] = -float(np.dot(z, eye))
    return m


def translation(x: float, y: float, z: float):
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = (x, y, z)
    return m


def rotation_y(angle: float):
    c, s = math.cos(angle), math.sin(angle)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float32
    )


def turn_view(view_matrix, pitch: float, yaw: float):
    """view_matrix (world -> view) turned in view space: pitch radians
    about x, then yaw radians about y. f32."""
    cp, sp, cy, sy = math.cos(pitch), math.sin(pitch), math.cos(yaw), math.sin(yaw)
    rot = np.eye(4)
    rot[:3, :3] = (np.array([[1, 0, 0], [0, cp, sp], [0, -sp, cp]])
                   @ np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]]))
    return (np.asarray(view_matrix, np.float64) @ rot).astype(np.float32)


def halton(i: int, b: int) -> float:
    """HaltonSequence (rt64_common.h:347-357)."""
    f, r = 1.0, 0.0
    while i > 0:
        f /= b
        r += f * (i % b)
        i //= b
    return r


def halton_jitter(frame: int, phases: int):
    """HaltonJitter (rt64_common.h:359-361): in [-0.5, 0.5]^2."""
    i = frame % phases + 1
    return (halton(i, 2) - 0.5, halton(i, 3) - 0.5)


def camera_uvw(view_i, fov_radians: float, aspect: float, near: float, far: float):
    """Pinhole camera basis (rt64_view.cpp:993-1010).

    Returns (cameraU, cameraV, cameraW) scaled by focal distance and
    half-extents, used to build non-normalized ray directions as
    ``d.x*U + d.y*V + W``.
    """
    focal = (near + far) / 2.0
    pos = view_i[3, :3]
    fwd = view_i[2, :3]  # [0,0,1,0] @ viewI (rt64_view.cpp:1800-1803)
    fwd = fwd / np.linalg.norm(fwd)
    target = pos + fwd * focal
    up = np.asarray([0.0, 1.0, 0.0], dtype=view_i.dtype)
    w = target - pos
    w = w / np.linalg.norm(w) * focal
    u = np.cross(w, up)
    u = u / np.linalg.norm(u)
    v = np.cross(u, w)
    v = v / np.linalg.norm(v)
    ulen = focal * math.tan(fov_radians * 0.5) * aspect
    vlen = focal * math.tan(fov_radians * 0.5)
    return u * ulen, v * vlen, w
