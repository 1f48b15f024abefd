"""Film + reconstruction-filter plugins (port of
mitsuba_tpu/film/plugins.py): `hdrfilm` and the `gaussian` filter with
filter importance sampling."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from mitsuba_tpu_torch.core.warp import square_to_std_normal
from mitsuba_tpu_torch.scene.registry import register

# reconstruction filter kinds, as numbered in the reference
BOX = 0
TENT = 1
GAUSSIAN = 2


@dataclass
class RFilterRecord:
    kind: int = BOX
    radius: float = 0.5
    stddev: float = 0.5


@register("rfilter", "gaussian")
class GaussianFilter:
    kind = GAUSSIAN

    def __init__(self, props):
        self.record = RFilterRecord(
            kind=GAUSSIAN, radius=2.0, stddev=props.get_float("stddev", 0.5)
        )


def filter_importance_sample(rec: RFilterRecord, u2):
    """Film-position jitter distributed as the reconstruction filter, so
    each sample lands in its own pixel with weight 1.  u2: [..., 2]
    uniforms; offsets are relative to the pixel corner."""
    if rec.kind != GAUSSIAN:
        raise NotImplementedError(f"rfilter kind {rec.kind} not yet ported")
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
