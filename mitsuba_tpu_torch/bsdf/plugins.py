"""BSDF plugins (port of mitsuba_tpu/bsdf/plugins.py): `diffuse` with an
RGB reflectance."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.scene.registry import register

# material types, as numbered in the reference
DIFFUSE = 0
NULL_BSDF = 12


def _gray(v):
    return np.full(3, v, np.float32)


@dataclass
class BSDFRecord:
    type: int = DIFFUSE
    cA: np.ndarray = field(default_factory=lambda: _gray(0.5))  # diffuse refl
    twosided: bool = False
    id: str = ""


@register("bsdf", "diffuse")
class Diffuse:
    """reference: src/bsdfs/diffuse.cpp"""

    def __init__(self, props):
        self.props = props
        if any(name == "reflectance" for name, _ in props.children):
            raise NotImplementedError("textured diffuse reflectance not yet ported")
        self.record = BSDFRecord(
            type=DIFFUSE,
            cA=props.get_spectrum("reflectance", _gray(0.5)),
            id=props.id,
        )
