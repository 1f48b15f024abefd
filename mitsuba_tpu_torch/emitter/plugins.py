"""Emitter plugins (port of mitsuba_tpu/emitter/plugins.py): `area`,
`point`, `spot`, `directional`, `collimated`, `constant` and `envmap`.
The sky family (`sky`, `sunsky`, `sun`) is not ported: the registry
refuses it by name."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.scene.registry import register

# emitter kinds, as numbered in the reference
AREA = 0
POINT = 1
SPOT = 2
DIRECTIONAL = 3
COLLIMATED = 4
CONSTANT = 5
ENVMAP = 6


@dataclass
class EmitterRecord:
    kind: int = AREA
    radiance: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32)
    )  # area / constant radiance; the envmap's is its image
    intensity: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32)
    )  # point / spot intensity, collimated power
    irradiance: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32)
    )  # directional
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 1], np.float32)
    )
    cutoff_angle_deg: float = 20.0
    beam_width_deg: float = 15.0
    sampling_weight: float = 1.0
    to_world: Transform = field(default_factory=Transform.identity)
    env_image: np.ndarray | None = None  # [H, W, 3] lat-long (envmap)
    scale: float = 1.0  # envmap radiance scale

    def is_delta(self):
        return self.kind in (POINT, SPOT, DIRECTIONAL, COLLIMATED)


def _record(props, kind, **kw):
    return EmitterRecord(
        kind=kind,
        sampling_weight=props.get_float("samplingWeight", 1.0),
        to_world=props.get_transform("toWorld"),
        **kw,
    )


def _origin_and_axis(rec):
    """The to_world image of the origin and of +z (unit)."""
    t = rec.to_world
    rec.position = t.transform_point_np(np.zeros(3)).astype(np.float32)
    d = t.transform_vector_np(np.array([0.0, 0.0, 1.0]))
    rec.direction = (d / np.linalg.norm(d)).astype(np.float32)


@register("emitter", "area")
class AreaEmitter:
    """reference: src/emitters/area.cpp"""

    def __init__(self, props):
        self.props = props
        self.record = _record(
            props, AREA, radiance=props.get_spectrum("radiance", np.ones(3, np.float32))
        )


@register("emitter", "point")
class PointEmitter:
    """reference: src/emitters/point.cpp"""

    def __init__(self, props):
        self.props = props
        self.record = _record(
            props, POINT, intensity=props.get_spectrum("intensity", np.ones(3, np.float32))
        )
        pos = props.get_point("position", None)
        if pos is not None:
            self.record.position = np.asarray(pos, np.float32)
        else:
            self.record.position = self.record.to_world.transform_point_np(
                np.zeros(3)
            ).astype(np.float32)


@register("emitter", "spot")
class SpotEmitter:
    """reference: src/emitters/spot.cpp, a linear falloff between
    beamWidth and cutoffAngle."""

    def __init__(self, props):
        self.props = props
        cutoff = props.get_float("cutoffAngle", 20.0)
        self.record = _record(
            props, SPOT,
            intensity=props.get_spectrum("intensity", np.ones(3, np.float32)),
            cutoff_angle_deg=cutoff,
            beam_width_deg=props.get_float("beamWidth", cutoff * 3.0 / 4.0),
        )
        _origin_and_axis(self.record)


@register("emitter", "directional")
class DirectionalEmitter:
    """reference: src/emitters/directional.cpp"""

    def __init__(self, props):
        self.props = props
        self.record = _record(
            props, DIRECTIONAL,
            irradiance=props.get_spectrum("irradiance", np.ones(3, np.float32)),
        )
        d = props.get_vector("direction", None)
        if d is None:
            d = self.record.to_world.transform_vector_np(np.array([0.0, 0.0, 1.0]))
        self.record.direction = (
            np.asarray(d, np.float64) / np.linalg.norm(d)
        ).astype(np.float32)


@register("emitter", "collimated")
class CollimatedEmitter:
    """reference: src/emitters/collimated.cpp, a zero-radius beam."""

    def __init__(self, props):
        self.props = props
        self.record = _record(
            props, COLLIMATED, intensity=props.get_spectrum("power", np.ones(3, np.float32))
        )
        _origin_and_axis(self.record)


@register("emitter", "constant")
class ConstantEmitter:
    """reference: src/emitters/constant.cpp"""

    def __init__(self, props):
        self.props = props
        self.record = EmitterRecord(
            kind=CONSTANT,
            radiance=props.get_spectrum("radiance", np.ones(3, np.float32)),
            sampling_weight=props.get_float("samplingWeight", 1.0),
        )


@register("emitter", "envmap")
class EnvMapEmitter:
    """reference: src/emitters/envmap.cpp, a lat-long image importance
    sampled by its luminance (scene/builder.py builds the table)."""

    def __init__(self, props):
        from mitsuba_tpu_torch.core.spectrum import srgb_degamma
        from mitsuba_tpu_torch.io.images import read_image

        self.props = props
        img, is_ldr = read_image(props.resolve_path(props.get_string("filename")))
        if is_ldr:
            img = srgb_degamma(img)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        self.record = _record(
            props, ENVMAP,
            env_image=np.asarray(img[..., :3], np.float32),
            scale=props.get_float("scale", 1.0),
        )
