"""Emitter plugins (port of mitsuba_tpu/emitter/plugins.py): `area` and
`constant`."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.scene.registry import register

# emitter kinds, as numbered in the reference
AREA = 0
CONSTANT = 5


@dataclass
class EmitterRecord:
    kind: int = AREA
    radiance: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    sampling_weight: float = 1.0


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
