"""Texture plugins (port of mitsuba_tpu/scene/textures.py; reference
src/textures/*, and the MIPMap-backed `bitmap`, src/librender/texture.cpp
and mipmap.h): `checkerboard`, `gridtexture`, `bitmap`, `scale` (folded
into the texture it wraps), and the geometry-driven `vertexcolors`,
`wireframe` and `curvature`.

Each plugin resolves to a `TextureDesc` that the scene builder packs
into the texture table and the bitmap atlas; scene/texture_eval.py
evaluates it per lane.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.core.spectrum import srgb_degamma
from mitsuba_tpu_torch.scene.registry import register

# texture kinds, as numbered in the reference
TEX_CONSTANT = 0
TEX_BITMAP = 1
TEX_CHECKERBOARD = 2
TEX_GRID = 3
TEX_VERTEXCOLORS = 4
TEX_WIREFRAME = 5
TEX_CURVATURE = 6
GEOMETRY_KINDS = (TEX_VERTEXCOLORS, TEX_WIREFRAME, TEX_CURVATURE)


@dataclass
class TextureDesc:
    kind: int = TEX_CONSTANT
    color0: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    color1: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    image: np.ndarray | None = None  # [H, W, 3] linear float32 (bitmap)
    uv_scale: tuple = (1.0, 1.0)
    uv_offset: tuple = (0.0, 0.0)
    # grid and wireframe line width; curvature's user scale
    line_width: float = 0.01
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))  # folded <scale>
    filter_nearest: bool = False

    def average(self) -> np.ndarray:
        if self.kind == TEX_BITMAP:
            avg = self.image.reshape(-1, 3).mean(axis=0)
        elif self.kind == TEX_CONSTANT:
            avg = self.color0
        else:
            avg = 0.5 * (self.color0 + self.color1)
        return (avg * self.scale).astype(np.float32)


def _uv(props):
    return (
        (props.get_float("uscale", 1.0), props.get_float("vscale", 1.0)),
        (props.get_float("uoffset", 0.0), props.get_float("voffset", 0.0)),
    )


class _TexBase:
    def __init__(self, props):
        self.desc = self._build(props)


@register("texture", "checkerboard")
class Checkerboard(_TexBase):
    """reference: src/textures/checkerboard.cpp (color0/color1, uv repeat)."""

    def _build(self, props):
        sc, off = _uv(props)
        return TextureDesc(
            kind=TEX_CHECKERBOARD,
            color0=props.get_spectrum("color0", np.full(3, 0.4, np.float32)),
            color1=props.get_spectrum("color1", np.full(3, 0.2, np.float32)),
            uv_scale=sc,
            uv_offset=off,
        )


@register("texture", "gridtexture")
class GridTexture(_TexBase):
    """reference: src/textures/gridtexture.cpp."""

    def _build(self, props):
        sc, off = _uv(props)
        return TextureDesc(
            kind=TEX_GRID,
            color0=props.get_spectrum("color0", np.full(3, 0.2, np.float32)),
            color1=props.get_spectrum("color1", np.full(3, 0.4, np.float32)),
            line_width=props.get_float("lineWidth", 0.01),
            uv_scale=sc,
            uv_offset=off,
        )


@register("texture", "bitmap")
class BitmapTexture(_TexBase):
    """reference: src/textures/bitmap.cpp: an image (EXR, PFM, RGBE, PNG)
    looked up through its mip pyramid; LDR files are linearized by the
    sRGB curve unless `gamma` gives an exponent; `filterType` "nearest"
    picks texels without interpolation."""

    def _build(self, props):
        from mitsuba_tpu_torch.io.images import read_image

        img, is_ldr = read_image(props.resolve_path(props.get_string("filename")))
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] > 3:
            img = img[..., :3]
        gamma = props.get_float("gamma", 0.0)
        if is_ldr:
            if gamma == 0.0:
                img = srgb_degamma(img)
            elif gamma > 0:
                img = np.power(np.maximum(img, 0.0), gamma)
        sc, off = _uv(props)
        return TextureDesc(
            kind=TEX_BITMAP,
            image=np.asarray(img, np.float32),
            uv_scale=sc,
            uv_offset=off,
            filter_nearest=props.get_string("filterType", "bilinear") == "nearest",
        )


@register("texture", "scale")
class ScaleTexture(_TexBase):
    """reference: src/textures/scale.cpp, folded into a copy of the nested
    texture (or of a constant `value`)."""

    def _build(self, props):
        scale = props.get_spectrum("scale", np.ones(3, np.float32))
        nested = None
        for _, child in props.children:
            if getattr(child, "desc", None) is not None:
                nested = child.desc
        if nested is None:
            nested = TextureDesc(kind=TEX_CONSTANT,
                                 color0=props.get_spectrum("value", np.ones(3, np.float32)))
        out = copy.copy(nested)
        out.scale = (np.asarray(nested.scale) * scale).astype(np.float32)
        return out


@register("texture", "vertexcolors")
class VertexColors(_TexBase):
    """reference: src/textures/vertexcolors.cpp: the mesh's vertex colours,
    interpolated."""

    def _build(self, props):
        return TextureDesc(kind=TEX_VERTEXCOLORS)


@register("texture", "wireframe")
class Wireframe(_TexBase):
    """reference: src/textures/wireframe.cpp (lineWidth 0: a tenth of the
    mean edge length, set by the builder)."""

    def _build(self, props):
        return TextureDesc(
            kind=TEX_WIREFRAME,
            color0=props.get_spectrum("interiorColor", np.full(3, 0.5, np.float32)),
            color1=props.get_spectrum("edgeColor", np.full(3, 0.1, np.float32)),
            line_width=props.get_float("lineWidth", 0.0),
        )


@register("texture", "curvature")
class Curvature(_TexBase):
    """reference: src/textures/curvature.cpp: mean or Gaussian curvature,
    red where positive, blue where negative, scaled into [-1, 1].  In the
    packed table line_width holds the user scale and uv_offset[0] selects
    Gaussian (1) over mean (0)."""

    def _build(self, props):
        which = props.get_string("curvature", "mean")
        return TextureDesc(
            kind=TEX_CURVATURE,
            line_width=props.get_float("scale", 1.0),
            uv_offset=(1.0 if which == "gaussian" else 0.0, 0.0),
        )


def as_texture_or_spectrum(props, name, default):
    """A parameter that may be an rgb/spectrum or a nested texture child
    (the reference's Spectrum-or-Texture pattern)."""
    for child_name, child in props.children:
        if child_name == name and getattr(child, "desc", None) is not None:
            return child.desc
    if name in props:
        raw = props.raw(name)
        if isinstance(raw, TextureDesc):
            return raw
        if hasattr(raw, "desc"):
            return raw.desc
        return TextureDesc(kind=TEX_CONSTANT, color0=props.get_spectrum(name))
    if isinstance(default, TextureDesc):
        return default
    return TextureDesc(
        kind=TEX_CONSTANT,
        color0=np.asarray(default, np.float32)
        if np.ndim(default)
        else np.full(3, float(default), np.float32),
    )
