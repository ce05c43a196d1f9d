"""The traffic generator: what a game pushes each frame, read from a
traffic file (portbench/traffic/<name>.json) and the seed. One
generator serves every mix; a mix is its parameters.

A frame's state is plain numpy (camera, every instance's transform and
the one before it, the character's pose, the scene's lights), handed
alike to the program side (program.py pushes it) and to the reference.
The seed picks which foliage moves and the phases of their sway and of
the character's pose; the orbit starts at the same angle for every seed,
so every seed's window draws the same views (the views set the
alpha-tested work and the memory it takes).

A mix with a `lights` block ({"resend": "every_frame", "moving": k,
"bob": world units, "rate": cycles per frame}) re-sends the light list
every frame, with k lights, which the seed picks with their phases,
bobbing up and down by `bob`. Without one the lights are the scene's,
set once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from portbench import scene as sc
from portbench.harness import UnknownName

# The one loop and present mode the harness drives, and the one way it
# re-sends lights. A mix that names another is refused, never run as
# these.
LOOP, PRESENT, RESEND = "closed", "full_sync", "every_frame"


def check_modes(traffic: dict):
    """Refuse a mix whose `loop` or `present` the harness does not drive
    (it draws in a closed loop, in the view's default full sync), or
    whose light block re-sends its lights otherwise than every frame."""
    for key, mode in (("loop", LOOP), ("present", PRESENT)):
        if traffic.get(key) != mode:
            raise UnknownName(f"traffic: {key} {traffic.get(key)!r} is not driven")
    lights = traffic.get("lights")
    if lights is not None and lights.get("resend") != RESEND:
        raise UnknownName(f"traffic: lights resend {lights.get('resend')!r} "
                          "is not driven")


@dataclasses.dataclass
class FrameState:
    index: int  # frames drawn before this one (the view's frame count)
    eye: np.ndarray  # (3,) f64
    target: np.ndarray  # (3,) f64
    view_matrix: np.ndarray  # (4, 4) f32, world -> view, row vectors
    transforms: List[np.ndarray]  # per instance (4, 4) f32
    previous: List[np.ndarray]  # per instance, the frame before's
    character: sc.MeshData  # the pose uploaded this frame
    lights: list  # the frame's lights, dicts of api Light fields
    resend_lights: bool  # the lights are set anew this frame


def look_at_rh(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """XMMatrixLookAtRH in row-vector form (world -> view), f32."""
    eye = np.asarray(eye, np.float64)
    z = eye - np.asarray(target, np.float64)
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = x, y, z
    m[3, :3] = (-x @ eye, -y @ eye, -z @ eye)
    return m.astype(np.float32)


class Walk:
    """The closed-loop walk of a traffic file over one scene and seed."""

    def __init__(self, traffic: dict, scene: sc.SceneData, seed: int):
        self.traffic = traffic
        self.scene = scene
        rng = np.random.default_rng([seed, 0x3A1C])
        orbit = traffic["orbit"]
        self.center = np.asarray(orbit["center"], np.float64)
        self.start_yaw = math.radians(orbit["start_deg"])
        fol = traffic["foliage"]
        self.moving = sorted(int(i) for i in rng.choice(
            scene.foliage, int(fol["moving"]), replace=False))
        self.sway_phase = rng.uniform(0.0, 2 * np.pi, len(self.moving))
        self.pose_phase = float(rng.uniform(0.0, 2 * np.pi))
        self.base = [inst.transform for inst in scene.instances]
        self.character = next(i for i, inst in enumerate(scene.instances)
                              if inst.mesh == "character")
        self.light_mix = traffic.get("lights")
        if self.light_mix is not None:
            lrng = np.random.default_rng([seed, 0x116E])
            self.bobbing = sorted(int(i) for i in lrng.choice(
                len(scene.lights), int(self.light_mix["moving"]), replace=False))
            self.bob_phase = lrng.uniform(0.0, 2 * np.pi, len(self.bobbing))

    @property
    def warmup_frames(self) -> int:
        return int(self.traffic["warmup_frames"])

    def _pose(self, f: int):
        orbit, ch = self.traffic["orbit"], self.traffic["character"]
        yaw = self.start_yaw + math.radians(orbit["yaw_deg_per_frame"]) * f
        eye = self.center + np.array([orbit["radius"] * math.sin(yaw),
                                      orbit["eye_height"],
                                      orbit["radius"] * math.cos(yaw)])
        target = self.center + np.array([0.0, orbit["target_height"], 0.0])
        # The character walks ahead of the camera, facing away from it.
        ahead = -np.array([math.sin(yaw), 0.0, math.cos(yaw)])
        base = eye + ahead * ch["distance"] - np.array([0.0, ch["drop"], 0.0])
        transforms = list(self.base)
        transforms[self.character] = (sc.rotation_y(yaw)
                                      @ sc.translation(*base)).astype(np.float32)
        fol = self.traffic["foliage"]
        for k, i in enumerate(self.moving):
            s = math.sin(self.sway_phase[k] + fol["rate"] * f)
            transforms[i] = (sc.rotation_y(fol["sway_rad"] * s)
                             @ sc.translation(fol["shift"] * s, 0.0, 0.0)
                             @ self.base[i]).astype(np.float32)
        return eye, target, transforms

    def frame(self, f: int) -> FrameState:
        ch = self.traffic["character"]
        eye, target, transforms = self._pose(f)
        _, _, previous = self._pose(f - 1)
        bend = ch["bend"] * math.sin(self.pose_phase + ch["rate"] * f)
        pose = sc.character_mesh(ch["rings"], ch["segments"], ch["height"],
                                 ch["radius"], bend)
        return FrameState(f, eye, target, look_at_rh(eye, target), transforms,
                          previous, pose, self._lights(f),
                          self.light_mix is not None)

    def _lights(self, f: int) -> list:
        """The scene's lights, the bobbing ones moved to frame f."""
        if self.light_mix is None:
            return self.scene.lights
        mix = self.light_mix
        lights = [dict(light) for light in self.scene.lights]
        for k, i in enumerate(self.bobbing):
            x, y, z = lights[i]["position"]
            dy = mix["bob"] * math.sin(self.bob_phase[k]
                                       + 2 * math.pi * mix["rate"] * f)
            lights[i]["position"] = (x, y + dy, z)
        return lights
