"""Emitter plugins (port of mitsuba_tpu/emitter/plugins.py): `area`,
`point`, `spot`, `directional`, `collimated`, `constant`, `envmap`, and
the daylight family baked on the host (emitter/sky.py): `sky` and
`sunsky` become lat-long `envmap` records, `sun` a `directional` one."""

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


def _sun_direction(props):
    """sunDirection property, or computed from date, time and location
    as the reference does (src/emitters/sunsky/sun.cpp configure)."""
    from mitsuba_tpu_torch.emitter.sky import sun_direction_from_time

    d = props.get_vector("sunDirection", None)
    if d is not None:
        d = np.asarray(d, np.float64)
        return d / np.linalg.norm(d)
    return sun_direction_from_time(
        int(props.get_int("year", 2010)),
        int(props.get_int("month", 7)),
        int(props.get_int("day", 10)),
        props.get_float("hour", 15.0) + props.get_float("minute", 0.0) / 60.0,
        props.get_float("latitude", 35.6894),
        props.get_float("longitude", 139.6917),
        props.get_float("timezone", 9.0),
    )


class _SkyBase:
    """A daylight model baked to a lat-long env map (= reference sky.cpp,
    which also rasterizes to a bitmap for sampling).  The default model
    is the Hosek-Wilkie dataset fit; `model="preetham"` selects the older
    analytic model."""

    with_sun = False

    def __init__(self, props):
        from mitsuba_tpu_torch.emitter.sky import hosek_sky_image, preetham_sky_image

        self.props = props
        model = props.get_string("model", "hosek").lower()
        bake = preetham_sky_image if model == "preetham" else hosek_sky_image
        scale = props.get_float("scale", 1.0)
        env_image = bake(
            props.get_float("turbidity", 3.0),
            _sun_direction(props),
            resolution=int(props.get_int("resolution", 512)) // 2,
            sky_scale=props.get_float("skyScale", 1.0) * scale,
            sun_scale=props.get_float("sunScale", 1.0) * scale,
            with_sun=self.with_sun,
            ground_albedo=float(np.mean(
                props.get_spectrum("groundAlbedo", np.full(3, 0.15, np.float32)))),
        )
        self.record = _record(props, ENVMAP, env_image=env_image)


@register("emitter", "sky")
class SkyEmitter(_SkyBase):
    """reference: src/emitters/sunsky/sky.cpp"""


@register("emitter", "sunsky")
class SunSkyEmitter(_SkyBase):
    """reference: src/emitters/sunsky/sunsky.cpp, the sky and the solar
    disk baked into the same map (its luminance table samples both)."""

    with_sun = True


@register("emitter", "sun")
class SunEmitter:
    """reference: src/emitters/sunsky/sun.cpp, a directional sun with
    Preetham atmospheric transmittance."""

    def __init__(self, props):
        from mitsuba_tpu_torch.emitter.sky import sun_irradiance_rgb

        self.props = props
        scale = props.get_float("scale", 1.0) * props.get_float("sunScale", 1.0)
        sun_dir = _sun_direction(props)
        irradiance = (
            sun_irradiance_rgb(sun_dir[1], props.get_float("turbidity", 3.0))
            * max(sun_dir[1], 0.0)  # irradiance on the ground plane
            * scale
        ).astype(np.float32)
        self.record = _record(props, DIRECTIONAL, irradiance=irradiance,
                              direction=(-sun_dir).astype(np.float32))
