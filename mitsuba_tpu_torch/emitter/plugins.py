"""Emitter plugins (port of mitsuba_tpu/emitter/plugins.py): `area`,
`constant` and `envmap`."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.scene.registry import register

# emitter kinds, as numbered in the reference
AREA = 0
CONSTANT = 5
ENVMAP = 6


@dataclass
class EmitterRecord:
    kind: int = AREA
    radiance: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32)
    )  # area / constant radiance; the envmap's is its image
    sampling_weight: float = 1.0
    to_world: Transform = field(default_factory=Transform.identity)
    env_image: np.ndarray | None = None  # [H, W, 3] lat-long (envmap)
    scale: float = 1.0  # envmap radiance scale


@register("emitter", "area")
class AreaEmitter:
    """reference: src/emitters/area.cpp"""

    def __init__(self, props):
        self.props = props
        self.record = EmitterRecord(
            kind=AREA,
            radiance=props.get_spectrum("radiance", np.ones(3, np.float32)),
            sampling_weight=props.get_float("samplingWeight", 1.0),
        )


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
        self.record = EmitterRecord(
            kind=ENVMAP,
            sampling_weight=props.get_float("samplingWeight", 1.0),
            to_world=props.get_transform("toWorld"),
            env_image=np.asarray(img[..., :3], np.float32),
            scale=props.get_float("scale", 1.0),
        )
