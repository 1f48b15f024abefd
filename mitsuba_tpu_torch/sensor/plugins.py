"""Sensor plugins + ray generation (port of mitsuba_tpu/sensor/plugins.py):
the `perspective` camera.

Ray generation reproduces the reference's sample->camera mapping
(reference perspective.cpp:145-157):
    d_cam ∝ ((1-2sx)·tan(xfov/2), (1-2sy)/aspect·tan(xfov/2), 1)
camera space is left-handed with +z the viewing direction and +x
pointing left on screen.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.transform import (
    Transform,
    transform_point_affine,
    transform_vector,
)
from mitsuba_tpu_torch.scene.registry import register

PERSPECTIVE = 0


@dataclass
class SensorRecord:
    kind: int = PERSPECTIVE
    to_world: Transform = field(default_factory=Transform.identity)
    xfov_deg: float = 40.0
    near_clip: float = 1e-2
    far_clip: float = 1e4
    ray_weight: float = 1.0  # constant sampleRay importance
    film = None  # attached by the XML loader
    sampler = None

    def pack(self, width, height, device):
        """Device-side parameter dict for generate_rays."""
        return {
            "kind": int(self.kind),
            "use_lens": False,
            "to_world": torch.tensor(
                self.to_world.m, dtype=torch.float32, device=device
            ),
            # float32-rounded scalars, as the reference packs them
            "tan_half_x": float(
                np.float32(math.tan(math.radians(self.xfov_deg) / 2.0))
            ),
            "aspect": float(np.float32(width / height)),
        }


def _resolve_xfov(props, aspect):
    """fov / fovAxis / focalLength handling
    (reference src/librender/sensor.cpp:221-264)."""
    if "focalLength" in props:
        # 35mm-film equivalent focal length (36x24mm frame, diagonal fov)
        f = props.get_float("focalLength", 50.0)
        diag = math.hypot(36.0, 24.0)
        fov = math.degrees(2.0 * math.atan(diag / (2.0 * f)))
        axis = "diagonal"
    else:
        fov = props.get_float("fov", 40.0)
        axis = props.get_string("fovAxis", "x").lower()
    if axis == "smaller":
        axis = "y" if aspect > 1 else "x"
    elif axis == "larger":
        axis = "x" if aspect > 1 else "y"
    t = math.tan(math.radians(fov) / 2.0)
    if axis == "x":
        return fov
    if axis == "y":
        return math.degrees(2.0 * math.atan(t * aspect))
    if axis == "diagonal":
        tx = t / math.sqrt(1.0 + 1.0 / (aspect * aspect))
        return math.degrees(2.0 * math.atan(tx))
    raise ValueError(f"bad fovAxis '{axis}'")


@register("sensor", "perspective")
class Perspective:
    kind = PERSPECTIVE

    def __init__(self, props):
        self.props = props
        self.record = SensorRecord(
            kind=self.kind,
            to_world=props.get_transform("toWorld"),
            near_clip=props.get_float("nearClip", 1e-2),
            far_clip=props.get_float("farClip", 1e4),
        )
        if props.get_float("shutterClose", 0.0) > props.get_float(
            "shutterOpen", 0.0
        ):
            raise NotImplementedError("motion blur (shutter) not yet ported")

    def resolve_fov(self, width, height):
        self.record.xfov_deg = _resolve_xfov(self.props, width / height)


def generate_rays(cam, pos01, u_lens):
    """World-space primary rays.

    cam: dict from SensorRecord.pack; pos01: [..., 2] film position in
    [0,1)^2 (x right, y down); u_lens: [..., 2] aperture samples (unused
    by the pinhole camera).  Returns (origins [...,3], directions [...,3]).
    """
    if cam["kind"] != PERSPECTIVE or cam["use_lens"]:
        raise NotImplementedError(f"sensor kind {cam['kind']} not yet ported")
    sx, sy = pos01[..., 0], pos01[..., 1]
    tw = cam["to_world"]
    th = cam["tan_half_x"]
    x = (1.0 - 2.0 * sx) * th
    y = (1.0 - 2.0 * sy) * th / cam["aspect"]
    d_cam = mm.normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))
    o_cam = torch.zeros_like(d_cam)
    o_world = transform_point_affine(tw, o_cam)
    d_world = mm.normalize(transform_vector(tw, d_cam))
    return o_world, d_world
