"""Emitter plugins (port of mitsuba_tpu/emitter/plugins.py): `area`."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.scene.registry import register

AREA = 0  # emitter kind, as numbered in the reference


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
