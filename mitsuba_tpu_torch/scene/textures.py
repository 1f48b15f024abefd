"""Texture plugins (port of mitsuba_tpu/scene/textures.py, the
procedural `checkerboard`; reference src/textures/checkerboard.cpp).

Each plugin resolves to a `TextureDesc` that the scene builder packs
into the texture table; scene/texture_eval.py evaluates it per lane.
The other texture plugins are not registered and raise
NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.scene.registry import register

# texture kinds, as numbered in the reference
TEX_CONSTANT = 0
TEX_CHECKERBOARD = 2


@dataclass
class TextureDesc:
    kind: int = TEX_CONSTANT
    color0: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    color1: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    uv_scale: tuple = (1.0, 1.0)
    uv_offset: tuple = (0.0, 0.0)
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))

    def average(self) -> np.ndarray:
        avg = self.color0 if self.kind == TEX_CONSTANT else 0.5 * (self.color0 + self.color1)
        return (avg * self.scale).astype(np.float32)


def _uv(props):
    return (
        (props.get_float("uscale", 1.0), props.get_float("vscale", 1.0)),
        (props.get_float("uoffset", 0.0), props.get_float("voffset", 0.0)),
    )


@register("texture", "checkerboard")
class Checkerboard:
    """reference: src/textures/checkerboard.cpp (color0/color1, uv repeat)."""

    def __init__(self, props):
        sc, off = _uv(props)
        self.desc = TextureDesc(
            kind=TEX_CHECKERBOARD,
            color0=props.get_spectrum("color0", np.full(3, 0.4, np.float32)),
            color1=props.get_spectrum("color1", np.full(3, 0.2, np.float32)),
            uv_scale=sc,
            uv_offset=off,
        )


def as_texture_or_spectrum(props, name, default):
    """A parameter that may be an rgb/spectrum or a nested texture child
    (the reference's Spectrum-or-Texture pattern)."""
    for child_name, child in props.children:
        if child_name == name and getattr(child, "desc", None) is not None:
            return child.desc
    if name in props:
        return TextureDesc(kind=TEX_CONSTANT, color0=props.get_spectrum(name))
    return TextureDesc(
        kind=TEX_CONSTANT,
        color0=np.asarray(default, np.float32)
        if np.ndim(default)
        else np.full(3, float(default), np.float32),
    )
