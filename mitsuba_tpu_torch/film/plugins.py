"""Film + reconstruction-filter plugins (port of
mitsuba_tpu/film/plugins.py).

Films (reference src/films/*): `hdrfilm` (EXR, RGBE or PFM),
`tiledhdrfilm` (the renderer renders it in row bands and spills each
developed band to a host memory-map, renderer.py), `ldrfilm` (PNG through
a gamma or Reinhard tonemap, `FilmRecord.develop_to_array`) and `mfilm`
(MATLAB text or numpy output for the measurement sensors).  Filters
(reference src/rfilters/*): `box`, `tent`, `gaussian`, `mitchell`,
`catmullrom` and `lanczos`.  The non-negative kernels (box, tent,
gaussian) support filter importance sampling; the others are splatted
(film/film.py).  As in the reference, the crop window, the pixel and
component formats, `banner` and `highQualityEdges` are parsed and not
applied, and mfilm's `digits` and `variable` do not reach its writer
(ROADMAP C8)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mitsuba_tpu_torch.core.spectrum import luminance, srgb_gamma
from mitsuba_tpu_torch.core.warp import square_to_std_normal, square_to_tent
from mitsuba_tpu_torch.scene.registry import register

# reconstruction filter kinds, as numbered in the reference
BOX = 0
TENT = 1
GAUSSIAN = 2
MITCHELL = 3
CATMULLROM = 4
LANCZOS = 5


@dataclass
class RFilterRecord:
    kind: int = BOX
    radius: float = 0.5
    stddev: float = 0.5
    b: float = 1.0 / 3.0
    c: float = 1.0 / 3.0
    lobes: int = 3


@register("rfilter", "box")
class BoxFilter:
    def __init__(self, props):
        self.record = RFilterRecord(kind=BOX, radius=0.5)


@register("rfilter", "tent")
class TentFilter:
    def __init__(self, props):
        self.record = RFilterRecord(kind=TENT, radius=1.0)


@register("rfilter", "gaussian")
class GaussianFilter:
    def __init__(self, props):
        self.record = RFilterRecord(
            kind=GAUSSIAN, radius=2.0, stddev=props.get_float("stddev", 0.5)
        )


@register("rfilter", "mitchell")
class MitchellFilter:
    def __init__(self, props):
        self.record = RFilterRecord(
            kind=MITCHELL, radius=2.0, b=props.get_float("B", 1.0 / 3.0),
            c=props.get_float("C", 1.0 / 3.0),
        )


@register("rfilter", "catmullrom")
class CatmullRomFilter:
    def __init__(self, props):
        self.record = RFilterRecord(kind=CATMULLROM, radius=2.0, b=0.0, c=0.5)


@register("rfilter", "lanczos")
class LanczosFilter:
    def __init__(self, props):
        lobes = props.get_int("lobes", 3)
        self.record = RFilterRecord(kind=LANCZOS, radius=float(lobes), lobes=lobes)


def filter_importance_sample(rec: RFilterRecord, u2):
    """Film-position jitter distributed as the reconstruction filter, so
    each sample lands in its own pixel with weight 1 (box, tent and
    gaussian only: see supports_fis).  u2: [..., 2] uniforms; offsets are
    relative to the pixel corner and may leave [0, 1)."""
    if rec.kind == BOX:
        return u2
    if rec.kind == TENT:
        return 0.5 + square_to_tent(u2)
    if rec.kind != GAUSSIAN:
        raise ValueError(f"rfilter kind {rec.kind} has negative lobes: splat it")
    n = square_to_std_normal(u2) * rec.stddev
    # clamp to the kernel support (bias < 1e-4 for radius = 4 sigma)
    n = torch.clamp(n, -rec.radius, rec.radius)
    return 0.5 + n


def supports_fis(rec: RFilterRecord) -> bool:
    return rec.kind in (BOX, TENT, GAUSSIAN)


@dataclass
class FilmRecord:
    width: int = 768
    height: int = 576
    crop_offset: tuple = (0, 0)
    crop_size: tuple | None = None
    file_format: str = "openexr"
    pixel_format: str = "rgb"
    component_format: str = "float16"
    banner: bool = False
    high_quality_edges: bool = False
    rfilter: RFilterRecord = field(
        default_factory=lambda: RFilterRecord(GAUSSIAN, 2.0)
    )
    # ldrfilm
    is_ldr: bool = False
    tonemap: str = "gamma"
    gamma: float = -1.0  # -1 = sRGB
    exposure: float = 0.0
    key: float = 0.18
    burn: float = 0.0
    # mfilm
    is_mfilm: bool = False
    digits: int = 4
    variable: str = "data"
    # tiledhdrfilm: banded rendering + host memory-map spill
    out_of_core: bool = False

    def develop_to_array(self, image):
        """Post-process a linear HDR image [H, W, 3] (numpy, host) for
        output (reference src/films/{hdrfilm,ldrfilm}.cpp develop): the
        image itself for an HDR film; for ldrfilm the exposure, the
        optional photographic tonemap (reference ldrfilm.cpp:267), then
        the sRGB curve (gamma <= 0) or 1/gamma, clamped to [0, 1]."""
        if not self.is_ldr:
            return image
        img = image * (2.0 ** self.exposure)
        if self.tonemap == "reinhard":
            lum = np.maximum(luminance(img), 1e-8)
            log_avg = np.exp(np.mean(np.log(lum + 1e-6)))
            lum_s = lum * (self.key / log_avg)
            burn = min(max(self.burn, 0.0), 1.0)
            lwhite = np.max(lum_s) * (1.0 - burn) + burn * 1e8
            mapped = lum_s * (1.0 + lum_s / (lwhite * lwhite)) / (1.0 + lum_s)
            img = img * (mapped / lum)[..., None]
        if self.gamma <= 0:
            return srgb_gamma(np.clip(img, 0.0, 1.0))
        return np.power(np.clip(img, 0.0, 1.0), 1.0 / self.gamma)

    def output_extension(self):
        if self.is_mfilm:
            return ".npy" if self.file_format == "numpy" else ".m"
        if self.is_ldr:
            return ".png"
        return {"openexr": ".exr", "rgbe": ".hdr", "pfm": ".pfm"}.get(self.file_format, ".exr")


class _FilmBase:
    """The properties every film parses (reference film.cpp), its filter
    child (a gaussian where it has none), then the film's own (`_finish`)."""

    def __init__(self, props):
        rec = FilmRecord(
            width=props.get_int("width", 768),
            height=props.get_int("height", 576),
            file_format=props.get_string("fileFormat", "openexr").lower(),
            pixel_format=props.get_string("pixelFormat", "rgb").lower(),
            component_format=props.get_string("componentFormat", "float16").lower(),
            banner=props.get_bool("banner", False),
            high_quality_edges=props.get_bool("highQualityEdges", False),
        )
        rec.crop_offset = (props.get_int("cropOffsetX", 0), props.get_int("cropOffsetY", 0))
        rec.crop_size = (props.get_int("cropWidth", rec.width),
                         props.get_int("cropHeight", rec.height))
        for _, child in props.children:
            if isinstance(getattr(child, "record", None), RFilterRecord):
                rec.rfilter = child.record
        self.record = rec
        self._finish(props)

    def _finish(self, props):
        pass


@register("film", "hdrfilm")
class HDRFilm(_FilmBase):
    pass


@register("film", "tiledhdrfilm")
class TiledHDRFilm(_FilmBase):
    """Out-of-core hdrfilm (reference src/films/tiledhdrfilm.cpp): the
    renderer renders row bands and flushes each developed band to a host
    memory-map, so the whole film never lies in device memory."""

    def _finish(self, props):
        self.record.out_of_core = True


@register("film", "ldrfilm")
class LDRFilm(_FilmBase):
    def _finish(self, props):
        rec = self.record
        rec.is_ldr = True
        rec.tonemap = props.get_string("tonemapMethod", "gamma")
        rec.gamma = props.get_float("gamma", -1.0)
        rec.exposure = props.get_float("exposure", 0.0)
        rec.key = props.get_float("key", 0.18)
        rec.burn = props.get_float("burn", 0.0)
        rec.file_format = "png"


@register("film", "mfilm")
class MFilm(_FilmBase):
    def _finish(self, props):
        rec = self.record
        rec.is_mfilm = True
        rec.digits = props.get_int("digits", 4)
        rec.variable = props.get_string("variable", "data")
        rec.file_format = props.get_string("fileFormat", "matlab").lower()
        # measurement films default to 1x1 and a box filter
        if "width" not in props:
            rec.width = 1
        if "height" not in props:
            rec.height = 1
        rec.rfilter = RFilterRecord(kind=BOX, radius=0.5)
