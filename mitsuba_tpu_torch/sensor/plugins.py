"""Sensor plugins + ray generation (port of mitsuba_tpu/sensor/plugins.py):
perspective, thinlens, orthographic, telecentric, spherical,
radiancemeter, fluencemeter, irradiancemeter and perspective_rdist
(reference src/sensors/*.cpp, src/librender/sensor.cpp).

Ray generation reproduces the reference's sample->camera mapping
(reference perspective.cpp:145-157):
    d_cam ∝ ((1-2sx)·tan(xfov/2), (1-2sy)/aspect·tan(xfov/2), 1)
camera space is left-handed with +z the viewing direction and +x
pointing left on screen.  The shutter (motion blur) is not ported: a
sensor whose shutter opens raises NotImplementedError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.core.transform import (
    Transform,
    transform_point_affine,
    transform_vector,
)
from mitsuba_tpu_torch.scene.registry import register

# sensor kinds, as numbered in the reference
PERSPECTIVE = 0
THINLENS = 1
ORTHOGRAPHIC = 2
SPHERICAL = 3
RADIANCEMETER = 4
TELECENTRIC = 5
RDIST = 6
FLUENCEMETER = 7
IRRADIANCEMETER = 8


def _f32(x):
    """A host scalar rounded to float32, as the reference packs it."""
    return float(np.float32(x))


@dataclass
class SensorRecord:
    kind: int = PERSPECTIVE
    to_world: Transform = field(default_factory=Transform.identity)
    xfov_deg: float = 40.0
    near_clip: float = 1e-2
    far_clip: float = 1e4
    focus_distance: float = 1e4
    aperture_radius: float = 0.0
    shutter_open: float = 0.0
    shutter_close: float = 0.0
    kc: tuple = (0.0, 0.0)  # radial distortion (perspective_rdist)
    ray_weight: float = 1.0  # constant sampleRay importance (meters)
    parent_shape: object = None  # irradiancemeter's host shape
    film = None  # attached by the XML loader
    sampler = None

    def pack(self, width, height, device):
        """Device-side parameter dict for generate_rays."""
        cam = {
            # static python values: only the scene's camera model runs
            "kind": int(self.kind),
            "use_lens": bool(
                self.kind in (THINLENS, TELECENTRIC) and self.aperture_radius > 0
                # irradiancemeter: the lens stream supplies the
                # reference's `otherSample` (cosine direction draw)
                or self.kind == IRRADIANCEMETER
            ),
            "kc": (float(self.kc[0]), float(self.kc[1])),
            "to_world": torch.tensor(self.to_world.m, dtype=torch.float32, device=device),
            "tan_half_x": _f32(math.tan(math.radians(self.xfov_deg) / 2.0)),
            "aspect": _f32(width / height),
            "near": _f32(self.near_clip),
            "focus_dist": _f32(self.focus_distance),
            "aperture": _f32(self.aperture_radius),
        }
        if self.kind == IRRADIANCEMETER:
            cam.update(self._pack_irr(device))
        return cam

    def _pack_irr(self, device):
        """Position-sampling tables for the parent shape
        (reference irradiancemeter.cpp sampleRay -> samplePosition)."""
        inst = self.parent_shape
        if inst is None:
            raise ValueError(
                "irradiancemeter must be attached to a shape "
                "(reference irradiancemeter.cpp:80-83)"
            )

        def tensor(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        if inst.spheres:
            s = inst.spheres[0]
            return {
                "irr_mode": "sphere",
                "irr_center": tensor(s.center),
                "irr_radius": _f32(s.radius),
                "irr_eps": _f32(1e-4 * max(s.radius, 1e-3)),
            }
        if inst.meshes:
            v0l, e1l, e2l = [], [], []
            for m in inst.meshes:
                p = np.asarray(m.positions, np.float32)
                idx = np.asarray(m.indices, np.int64)
                v0l.append(p[idx[:, 0]])
                e1l.append(p[idx[:, 1]] - p[idx[:, 0]])
                e2l.append(p[idx[:, 2]] - p[idx[:, 0]])
            v0 = np.concatenate(v0l)
            e1 = np.concatenate(e1l)
            e2 = np.concatenate(e2l)
            area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            total = max(float(area.sum()), 1e-12)
            cdf = np.cumsum(area / total).astype(np.float32)
            cdf[-1] = 1.0
            return {
                "irr_mode": "mesh",
                "irr_v0": tensor(v0),
                "irr_e1": tensor(e1),
                "irr_e2": tensor(e2),
                "irr_cdf": tensor(cdf),
                "irr_eps": _f32(1e-4 * max(math.sqrt(total), 1e-3)),
            }
        raise ValueError("irradiancemeter: parent shape has no geometry")


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


class _SensorBase:
    kind = PERSPECTIVE
    has_fov = True  # the perspective family resolves its field of view

    def __init__(self, props):
        self.props = props
        self.record = SensorRecord(
            kind=self.kind,
            to_world=props.get_transform("toWorld"),
            near_clip=props.get_float("nearClip", 1e-2),
            far_clip=props.get_float("farClip", 1e4),
            focus_distance=props.get_float("focusDistance", 1e4),
            shutter_open=props.get_float("shutterOpen", 0.0),
            shutter_close=props.get_float("shutterClose", 0.0),
        )
        if self.record.shutter_close > self.record.shutter_open:
            raise NotImplementedError("motion blur (shutter) not yet ported")
        self._finish(props)

    def _finish(self, props):
        pass

    def resolve_fov(self, width, height):
        if self.has_fov:
            self.record.xfov_deg = _resolve_xfov(self.props, width / height)


@register("sensor", "perspective")
class Perspective(_SensorBase):
    kind = PERSPECTIVE


@register("sensor", "thinlens")
class ThinLens(_SensorBase):
    kind = THINLENS

    def _finish(self, props):
        self.record.aperture_radius = props.get_float("apertureRadius", 0.1)


@register("sensor", "orthographic")
class Orthographic(_SensorBase):
    kind = ORTHOGRAPHIC
    has_fov = False


@register("sensor", "telecentric")
class Telecentric(_SensorBase):
    """reference: src/sensors/telecentric.cpp, an orthographic projection
    with a finite aperture focused at focusDistance (rays converge from
    the aperture disk to the per-pixel focus point)."""

    kind = TELECENTRIC
    has_fov = False

    def _finish(self, props):
        self.record.aperture_radius = props.get_float("apertureRadius", 0.0)


@register("sensor", "spherical")
class Spherical(_SensorBase):
    kind = SPHERICAL
    has_fov = False


@register("sensor", "radiancemeter")
class RadianceMeter(_SensorBase):
    kind = RADIANCEMETER
    has_fov = False


@register("sensor", "fluencemeter")
class FluenceMeter(_SensorBase):
    """reference: src/sensors/fluencemeter.cpp, an isotropic point probe
    measuring the average radiance through its position (uniform-sphere
    ray directions, unit importance)."""

    kind = FLUENCEMETER
    has_fov = False


@register("sensor", "irradiancemeter")
class IrradianceMeter(_SensorBase):
    """reference: src/sensors/irradiancemeter.cpp, the average irradiance
    over the surface of its parent shape: position area-sampled on the
    shape, direction cosine-weighted about the normal, constant
    importance pi.  The XML loader attaches the parent (a sensor nested
    in a <shape>)."""

    kind = IRRADIANCEMETER
    has_fov = False

    def _finish(self, props):
        if "toWorld" in props:
            raise ValueError(
                "irradiancemeter: 'toWorld' is not allowed - the "
                "transformation is inherited from the parent shape "
                "(reference irradiancemeter.cpp:80-83)"
            )
        self.record.ray_weight = float(np.pi)


@register("sensor", "perspective_rdist")
class PerspectiveRDist(_SensorBase):
    """reference: src/sensors/perspective_rdist.cpp, perspective with the
    2nd/4th-order radial distortion polynomial kc undone during ray
    generation (Newton inversion, perspective_rdist.cpp invertDistortion)."""

    kind = RDIST

    def _finish(self, props):
        kc = [float(x) for x in props.get_string("kc", "0, 0").replace(",", " ").split()]
        while len(kc) < 2:
            kc.append(0.0)
        self.record.kc = (kc[0], kc[1])


def _div(num, den):
    """A host scalar over a tensor as a true division (torch's
    `scalar / tensor` multiplies by the reciprocal)."""
    return torch.div(torch.full_like(den, num), den)


def _plane(x, y):
    """[..., 3] points (x, y, 0)."""
    return torch.stack([x, y, torch.zeros_like(x)], dim=-1)


def _plus_z(shape, like):
    return torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=like.device).expand(
        shape + (3,))


def _uniform_sphere(sx, sy):
    z = 1.0 - 2.0 * sy
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * sx
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def generate_rays(cam, pos01, u_lens):
    """World-space primary rays.

    cam: dict from SensorRecord.pack; pos01: [..., 2] film position in
    [0,1)^2 (x right, y down); u_lens: [..., 2] aperture samples (the
    irradiancemeter's direction draw).  Returns (origins [...,3],
    directions [...,3])."""
    sx, sy = pos01[..., 0], pos01[..., 1]
    tw = cam["to_world"]
    kind = cam["kind"]
    th = cam["tan_half_x"]
    aspect = cam["aspect"]

    if kind in (PERSPECTIVE, THINLENS, RDIST):
        x = (1.0 - 2.0 * sx) * th
        y = (1.0 - 2.0 * sy) * th / aspect
        if kind == RDIST:
            # undo the calibrated radial distortion: solve
            # r'(1 + kc0 r'^2 + kc1 r'^4) = r by Newton iteration
            kc0, kc1 = cam["kc"]
            r = torch.sqrt(x * x + y * y)
            rp = r
            for _ in range(5):
                r2 = rp * rp
                f = rp * (1.0 + r2 * (kc0 + r2 * kc1)) - r
                df = 1.0 + r2 * (3.0 * kc0 + 5.0 * kc1 * r2)
                rp = rp - f / df
            corr = torch.where(r > 1e-9, rp / torch.clamp(r, min=1e-9), 1.0)
            x = x * corr
            y = y * corr
        d_cam = mm.normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))
        o_cam = torch.zeros_like(d_cam)
        if cam["use_lens"]:
            # thinlens: the origin on the aperture disk, re-aimed at the
            # focal plane (reference src/sensors/thinlens.cpp sampleRay)
            p_lens = warp.square_to_uniform_disk_concentric(u_lens) * cam["aperture"]
            t_focus = _div(cam["focus_dist"], torch.clamp(d_cam[..., 2], min=1e-6))
            p_focus = d_cam * t_focus[..., None]
            o_cam = _plane(p_lens[..., 0], p_lens[..., 1])
            d_cam = mm.normalize(p_focus - o_cam)
    elif kind == TELECENTRIC:
        # orthographic projection with a finite aperture focused at
        # focusDistance (reference telecentric.cpp sampleRay: the origin
        # on the shifted aperture disk, toward the focus point)
        img = _plane(1.0 - 2.0 * sx, (1.0 - 2.0 * sy) / aspect)
        if cam["use_lens"]:
            p_lens = warp.square_to_uniform_disk_concentric(u_lens) * cam["aperture"]
            o_cam = img + _plane(p_lens[..., 0], p_lens[..., 1])
            focus_p = img + torch.stack(
                [torch.zeros_like(sx), torch.zeros_like(sx),
                 torch.full_like(sx, cam["focus_dist"])], dim=-1)
            d_cam = mm.normalize(focus_p - o_cam)
        else:
            o_cam = img
            d_cam = _plus_z(sx.shape, sx)
    elif kind == ORTHOGRAPHIC:
        # parallel rays from the image plane (reference
        # src/sensors/orthographic.cpp; extent [-1,1] x aspect)
        o_cam = _plane(1.0 - 2.0 * sx, (1.0 - 2.0 * sy) / aspect)
        d_cam = _plus_z(sx.shape, sx)
    elif kind == SPHERICAL:
        # full lat-long panorama (reference src/sensors/spherical.cpp)
        theta = sy * math.pi
        phi = sx * 2.0 * math.pi - math.pi / 2.0
        d_cam = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                             torch.sin(theta) * torch.sin(phi)], dim=-1)
        o_cam = torch.zeros_like(d_cam)
    elif kind == RADIANCEMETER:
        # a single ray along +z
        o_cam = torch.zeros(sx.shape + (3,), dtype=torch.float32, device=sx.device)
        d_cam = _plus_z(sx.shape, sx)
    elif kind == FLUENCEMETER:
        # isotropic point probe: uniform-sphere directions, the film
        # averages the radiance through the point (reference
        # fluencemeter.cpp sampleRay, weight 1)
        d_cam = _uniform_sphere(sx, sy)
        o_cam = torch.zeros_like(d_cam)
    elif kind == IRRADIANCEMETER:
        # surface probe: the origin sampled on the parent shape (pixel
        # sample -> area CDF), the direction cosine-weighted about the
        # normal, the constant weight pi applied at develop time
        # (reference irradiancemeter.cpp sampleRay:105-121).  The parent
        # geometry is already world space: to_world is the identity.
        if cam["irr_mode"] == "sphere":
            n = _uniform_sphere(sx, sy)
            p = cam["irr_center"] + cam["irr_radius"] * n
        else:
            cdf = cam["irr_cdf"]
            ti = torch.clamp(torch.searchsorted(cdf, sx.contiguous(), right=True), 0,
                             cdf.shape[0] - 1)
            lo = torch.where(ti > 0, cdf[torch.clamp(ti - 1, min=0)], 0.0)
            hi = cdf[ti]
            u1 = torch.clamp((sx - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
            t = torch.sqrt(torch.clamp(u1, min=0.0))
            b1 = 1.0 - t
            b2 = sy * t
            e1, e2 = cam["irr_e1"][ti], cam["irr_e2"][ti]
            p = cam["irr_v0"][ti] + b1[..., None] * e1 + b2[..., None] * e2
            n = mm.normalize(mm.cross(e1, e2))
        local = warp.square_to_cosine_hemisphere(u_lens)
        d_cam = mm.Frame.from_normal(n).to_world(local)
        o_cam = p + n * cam["irr_eps"]
    else:
        raise ValueError(f"generate_rays: unknown sensor kind {kind}")

    o_world = transform_point_affine(tw, o_cam)
    d_world = mm.normalize(transform_vector(tw, d_cam))
    return o_world, d_world
