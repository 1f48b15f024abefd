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
exactly instead of from the reference's 31-entry LUT).  `splat_add` is
the light image's scatter (bdpt's t = 1 strategies): a filtered splat at
an arbitrary position, normalized over its footprint.  The reference's
general scatter `splat` is not ported: none of its modules calls it.
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


def splat_grid(film, jitter, value, rfilter: RFilterRecord, valid=None):
    """Grid-aligned splat: one sample per (sample, pixel) lane.

    film: [H, W, 4]; jitter: [S, H, W, 2], each sample's position inside
    its pixel in [0, 1); value: [S, H, W, 3]; valid: optional [S, H, W]
    mask, a lane outside it adding neither value nor weight (the rows of a
    row band's halo that lie outside the frame).  Non-finite values count
    as 0.  Returns the updated film."""
    h, w = film.shape[0], film.shape[1]
    value = torch.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0)
    jx, jy = jitter[..., 0], jitter[..., 1]
    vmask = None if valid is None else valid.to(value.dtype)[..., None]
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
            if vmask is not None:
                wgt = wgt * vmask
            contrib = torch.cat([value * wgt, wgt], dim=-1).sum(dim=0)  # [H, W, 4]
            # shift by (dy, dx) with zero padding and add
            ys = slice(max(dy, 0), h + min(dy, 0))
            yd = slice(max(-dy, 0), h + min(-dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            xd = slice(max(-dx, 0), w + min(-dx, 0))
            out[ys, xs] += contrib[yd, xd]
    return out


def splat_add(img, pos, value, rfilter: RFilterRecord, valid=None):
    """Additive reconstruction-filtered splat with no weight channel (the
    light image, whose normalization is the sample count; reference
    bdpt_wr.cpp).  Each splat is normalized over its footprint, so it
    deposits exactly `value`.  img: [H, W, 3]; pos: [R, 2] continuous
    pixel coordinates; value: [R, 3].  Returns the updated image.  On the
    card the adds land in any order (index_add_), so the sums may differ
    from run to run in the last places."""
    h, w = img.shape[0], img.shape[1]
    radius = rfilter.radius
    fw = int(math.ceil(2.0 * radius))
    value = torch.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0)
    if valid is not None:
        value = torch.where(valid[..., None], value, 0.0)
    # non-finite positions (masked-out lanes) must not alias to pixel 0: a
    # NaN cast to an integer is undefined
    x = torch.nan_to_num(pos[..., 0], nan=-1e6, posinf=1e6, neginf=-1e6)
    y = torch.nan_to_num(pos[..., 1], nan=-1e6, posinf=1e6, neginf=-1e6)
    x0 = torch.floor(x - radius + 0.5).to(torch.int32)
    y0 = torch.floor(y - radius + 0.5).to(torch.int32)

    # pass 1: the footprint's weight total (per-splat normalization)
    wsum = torch.zeros_like(x)
    taps = []
    for dy in range(fw):
        py = y0 + dy
        wy = filter_eval_1d(rfilter, py.to(torch.float32) + 0.5 - y)
        for dx in range(fw):
            px = x0 + dx
            wx = filter_eval_1d(rfilter, px.to(torch.float32) + 0.5 - x)
            wgt = torch.clamp(wx * wy, min=0.0)
            taps.append((px, py, wgt))
            wsum = wsum + wgt
    inv = 1.0 / torch.clamp(wsum, min=1e-12)

    flat = img.reshape(-1, 3).clone()
    for px, py, wgt in taps:
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        idx = torch.where(inside, py * w + px, 0)
        amount = torch.where(inside, wgt * inv, 0.0)[..., None]
        flat.index_add_(0, idx, value * amount)
    return flat.reshape(h, w, 3)
