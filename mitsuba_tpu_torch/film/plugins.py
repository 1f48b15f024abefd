"""Film + reconstruction-filter plugins (port of
mitsuba_tpu/film/plugins.py): `hdrfilm` and the filters `box`, `tent`,
`gaussian`, `mitchell`, `catmullrom` and `lanczos` (reference
src/rfilters/*).  The non-negative kernels (box, tent, gaussian) support
filter importance sampling; the others are splatted (film/film.py)."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

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
    rfilter: RFilterRecord = field(
        default_factory=lambda: RFilterRecord(GAUSSIAN, 2.0)
    )


@register("film", "hdrfilm")
class HDRFilm:
    def __init__(self, props):
        rec = FilmRecord(
            width=props.get_int("width", 768),
            height=props.get_int("height", 576),
        )
        for _, child in props.children:
            if isinstance(getattr(child, "record", None), RFilterRecord):
                rec.rfilter = child.record
        self.record = rec
