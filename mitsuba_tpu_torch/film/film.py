"""Film accumulation (port of mitsuba_tpu/film/film.py: the dense path,
`filter_eval_1d` and the grid-aligned splat `splat_grid`).

The film carries (weighted RGB sum, weight sum) per pixel.  With filter
importance sampling every sample adds weight 1 to its own pixel, so a
render pass accumulates with dense adds and no scatter.  Filters with
negative lobes (mitchell, catmullrom, lanczos), and every media scene,
go through `splat_grid`: each (sample, pixel) lane splats into its
filter footprint as a sum over samples followed by one static shifted
add per footprint offset (reference ImageBlock::put,
include/mitsuba/render/imageblock.h:113-170, with the kernels evaluated
exactly instead of from the reference's 31-entry LUT).  The general
scatter `splat` is not ported: no ported path calls it.
"""

from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.film.plugins import (
    BOX,
    CATMULLROM,
    GAUSSIAN,
    LANCZOS,
    MITCHELL,
    TENT,
    RFilterRecord,
)


def new_film(height, width, device):
    """(weighted rgb, weight) accumulator [H, W, 4]."""
    return torch.zeros((height, width, 4), dtype=torch.float32, device=device)


def develop(film):
    """Weighted average -> final image [H, W, 3]."""
    w = film[..., 3:4]
    return torch.where(w > 1e-8, film[..., :3] / torch.clamp(w, min=1e-8), 0.0)


def filter_eval_1d(rec: RFilterRecord, x):
    """The (static) reconstruction kernel at offsets x (a tensor)."""
    ax = torch.abs(x)
    if rec.kind == BOX:
        return torch.where(ax <= 0.5, 1.0, 0.0)
    if rec.kind == TENT:
        return torch.clamp(1.0 - ax, min=0.0)
    if rec.kind == GAUSSIAN:
        alpha = -1.0 / (2.0 * rec.stddev * rec.stddev)
        return torch.clamp(
            torch.exp(alpha * ax * ax) - math.exp(alpha * rec.radius * rec.radius), min=0.0
        )
    if rec.kind in (MITCHELL, CATMULLROM):
        b, c = rec.b, rec.c
        x2 = ax * ax
        x3 = x2 * ax
        inner = (
            (12.0 - 9.0 * b - 6.0 * c) * x3 + (-18.0 + 12.0 * b + 6.0 * c) * x2
            + (6.0 - 2.0 * b)
        ) * (1.0 / 6.0)
        outer = (
            (-b - 6.0 * c) * x3 + (6.0 * b + 30.0 * c) * x2 + (-12.0 * b - 48.0 * c) * ax
            + (8.0 * b + 24.0 * c)
        ) * (1.0 / 6.0)
        return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, 0.0))
    if rec.kind == LANCZOS:
        def sinc(t):
            t = torch.abs(t) * math.pi
            return torch.where(t < 1e-5, 1.0, torch.sin(t) / torch.clamp(t, min=1e-20))

        return torch.where(ax < rec.radius, sinc(ax) * sinc(ax / rec.lobes), 0.0)
    raise ValueError(f"unknown filter kind {rec.kind}")


def splat_grid(film, jitter, value, rfilter: RFilterRecord):
    """Grid-aligned splat: one sample per (sample, pixel) lane.

    film: [H, W, 4]; jitter: [S, H, W, 2], each sample's position inside
    its pixel in [0, 1); value: [S, H, W, 3].  Non-finite values count as
    0.  Returns the updated film."""
    h, w = film.shape[0], film.shape[1]
    value = torch.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0)
    jx, jy = jitter[..., 0], jitter[..., 1]
    # receiving pixel offsets d satisfy |d + 0.5 - j| < radius for some
    # j in [0, 1): d in (-0.5 - r, 0.5 + r)
    lo = int(math.floor(-0.5 - rfilter.radius)) + 1
    hi = int(math.ceil(0.5 + rfilter.radius)) - 1
    out = film.clone()
    for dy in range(lo, hi + 1):
        wy = filter_eval_1d(rfilter, dy + 0.5 - jy)
        for dx in range(lo, hi + 1):
            wx = filter_eval_1d(rfilter, dx + 0.5 - jx)
            wgt = (wx * wy)[..., None]
            contrib = torch.cat([value * wgt, wgt], dim=-1).sum(dim=0)  # [H, W, 4]
            # shift by (dy, dx) with zero padding and add
            ys = slice(max(dy, 0), h + min(dy, 0))
            yd = slice(max(-dy, 0), h + min(-dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            xd = slice(max(-dx, 0), w + min(-dx, 0))
            out[ys, xs] += contrib[yd, xd]
    return out
