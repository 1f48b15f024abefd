"""Emitter sampling and evaluation (port of mitsuba_tpu/emitter/eval.py,
the area-light, constant- and image-environment branches of
Scene::sampleEmitterDirect / pdfEmitterDirect / evalEnvironment,
reference src/librender/scene.cpp:828-841).  The returned `value` is
Le/pdf with the emitter-selection probability folded in.

The envmap is a lat-long image (reference src/emitters/envmap.cpp),
looked up bilinearly and sampled through the pack's alias table of its
luminance x sin(theta) density (scene/builder.py `_env_table`).  Its
tables are read with 1D gathers of int32 ids (`index_select`), every id
wrapped or clamped into its table."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.core.gather import take_fused
from mitsuba_tpu_torch.emitter.plugins import AREA, CONSTANT, ENVMAP

ENV_DIST = 1e7  # pseudo-distance for env/directional lights
INV_PI = 1.0 / math.pi
INV_TWOPI = 0.5 / math.pi
INV_FOURPI = 0.25 / math.pi
PORTED_KINDS = frozenset({AREA, CONSTANT, ENVMAP})


class DirectSample(NamedTuple):
    d: torch.Tensor  # [R, 3] unit direction ref -> light
    dist: torch.Tensor  # [R]
    pdf: torch.Tensor  # [R] solid-angle pdf incl. emitter PMF
    value: torch.Tensor  # [R, 3] Le / pdf
    delta: torch.Tensor  # [R] bool
    n: torch.Tensor  # [R, 3] light-side normal (area lights)
    kind: torch.Tensor  # [R] int32 emitter kind


def _searchsorted_segment(cdf, u, lo, hi):
    """Per lane: the smallest i in [lo, hi) with u < cdf[i], clamped to
    hi-1, by counting the segment's entries at or below u."""
    j = torch.arange(cdf.shape[0], dtype=torch.int32, device=cdf.device)
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    inseg = (j[None, :] >= lo[:, None]) & (j[None, :] < hi[:, None])
    below = inseg & (u[:, None] >= cdf[None, :])
    cnt = below.sum(dim=-1, dtype=torch.int32)
    return torch.minimum(lo + cnt, torch.maximum(hi - 1, lo))


def _sample_area(pack, e, pmf, rgb, p_ref, u2):
    """Area branch: a triangle from the emitter's area CDF, then a
    uniform point on it.  Returns (d, dist, pdf, value, n)."""
    em_lo, em_hi, area = take_fused(e, pack.em_tri_lo, pack.em_tri_hi, pack.em_area)
    tri_slot = _searchsorted_segment(pack.area_tri_cdf, u2[..., 0], em_lo, em_hi)
    cdf_prev = torch.cat([pack.area_tri_cdf.new_zeros(1), pack.area_tri_cdf[:-1]])
    tri, hi_c, prev_c = take_fused(
        tri_slot, pack.area_tri_idx, pack.area_tri_cdf, cdf_prev
    )
    lo_c = torch.where(tri_slot > em_lo, prev_c, 0.0)
    u0 = torch.clamp(
        (u2[..., 0] - lo_c) / torch.clamp(hi_c - lo_c, min=1e-12),
        0.0, mm.ONE_MINUS_EPS,
    )
    bary = warp.square_to_uniform_triangle(torch.stack([u0, u2[..., 1]], dim=-1))
    v0, e1, e2 = take_fused(tri, pack.tri_v0, pack.tri_e1, pack.tri_e2)
    p_l = v0 + bary[..., 0:1] * e1 + bary[..., 1:2] * e2
    ng = mm.normalize(mm.cross(e1, e2))
    to_l = p_l - p_ref
    dist = mm.length(to_l)
    d = to_l / torch.clamp(dist, min=1e-12)[..., None]
    cos_l = -mm.dot(d, ng)
    # pdf_area = 1/area, converted to solid angle
    pdf = pmf * (dist * dist) / torch.clamp(cos_l * area, min=1e-12)
    ok = cos_l > 1e-6  # one-sided area emitters (reference area.cpp)
    value = torch.where(
        (ok & (pdf > 0))[..., None],
        rgb / torch.clamp(pdf, min=1e-12)[..., None],
        0.0,
    )
    return d, dist, pdf, value, ng


def _env_uv_from_dir(pack, d):
    """World direction -> lat-long uv (reference envmap.cpp eval)."""
    dl = mm.normalize(d @ pack.env_to_local[:3, :3].T)
    u = torch.atan2(dl[..., 0], -dl[..., 2]) * INV_TWOPI
    u = torch.where(u < 0.0, u + 1.0, u)
    v = mm.safe_acos(torch.clamp(dl[..., 1], -1.0, 1.0)) * INV_PI
    return torch.stack([u, v], dim=-1)


def _env_dir_from_uv(pack, uv):
    phi = uv[..., 0] * 2.0 * math.pi
    theta = uv[..., 1] * math.pi
    st = torch.sin(theta)
    dl = torch.stack([st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)], dim=-1)
    return mm.normalize(dl @ pack.env_to_world[:3, :3].T)


def _env_bilinear(pack, uv):
    """The image at lat-long uv, bilinear, columns wrapped (floor-mod)
    and rows clamped; the four texels in one gather."""
    img = pack.env_image
    h, w = img.shape[0], img.shape[1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    xs = torch.remainder(torch.stack([x0, x0 + 1]), w)
    ys = torch.clamp(torch.stack([y0, y0 + 1]), 0, h - 1) * w
    ids = torch.stack([ys[0] + xs[0], ys[0] + xs[1], ys[1] + xs[0], ys[1] + xs[1]])
    t = img.reshape(-1, img.shape[-1]).index_select(0, ids.reshape(-1)).reshape(
        ids.shape + (img.shape[-1],)
    )
    return (
        t[0] * (1 - ax) * (1 - ay)
        + t[1] * ax * (1 - ay)
        + t[2] * (1 - ax) * ay
        + t[3] * ax * ay
    )


def _env_pdf_dir(pack, d):
    """Solid-angle pdf of environment sampling toward d (no PMF factor)."""
    if not pack.meta.get("has_envmap", False):
        return torch.full(d.shape[:-1], INV_FOURPI, dtype=torch.float32, device=d.device)
    uv = _env_uv_from_dir(pack, d)
    h, w = pack.env_density.shape
    col = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)  # uv >= 0: truncation
    row = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
    dens = pack.env_density.reshape(-1).index_select(0, row * w + col)
    sin_t = torch.clamp(torch.sin(uv[..., 1] * math.pi), min=1e-6)
    return dens / (2.0 * math.pi * math.pi * sin_t)


def _sample_env_dir(pack, u2):
    """Importance-sample the image's per-pixel density through the alias
    table: one table row per draw, where the reference's hierarchical 2D
    CDF (envmap.cpp sampleDirection) takes a search.  The same density,
    so the same pdfs and MIS weights; only the u -> pixel map differs.
    Returns (d, solid-angle pdf)."""
    h, w = pack.env_density.shape
    n = h * w
    x = u2[..., 0] * n
    i = torch.clamp(x.to(torch.int32), 0, n - 1)
    jx = x - i.to(torch.float32)  # uniform, independent of i
    u_acc = u2[..., 1]
    if pack.meta.get("env_alias_fused_ok", False):
        # one 16-byte row: [prob, alias id, dens_self, dens_alias]
        rowv = pack.env_alias_fused.index_select(0, i)
        p_i = rowv[..., 0]
        accept = u_acc < p_i
        idx = torch.where(accept, i, rowv[..., 1].to(torch.int32))
        dens = torch.where(accept, rowv[..., 2], rowv[..., 3])
    else:
        p_i = pack.env_alias_prob.index_select(0, i)
        accept = u_acc < p_i
        idx = torch.where(accept, i, pack.env_alias_idx.index_select(0, i))
        dens = pack.env_density.reshape(-1).index_select(0, idx)
    # recycle the accept uniform (conditionally uniform either way)
    jy = torch.where(
        accept,
        u_acc / torch.clamp(p_i, min=1e-12),
        (u_acc - p_i) / torch.clamp(1.0 - p_i, min=1e-12),
    )
    jy = torch.clamp(jy, 0.0, mm.ONE_MINUS_EPS)
    row = idx // w
    col = idx - row * w
    u = (col.to(torch.float32) + jx) / w
    v = (row.to(torch.float32) + jy) / h
    d = _env_dir_from_uv(pack, torch.stack([u, v], dim=-1))
    sin_t = torch.clamp(torch.sin(v * math.pi), min=1e-6)
    return d, dens / (2.0 * math.pi * math.pi * sin_t)


def sample_direct(pack, p_ref, u3):
    """NEE: pick an emitter and sample a direction toward it.
    u3: [R, 3] uniforms (selection + 2D).  Returns DirectSample."""
    kinds = set(pack.meta.get("emitter_kinds", (AREA,)))
    if kinds - PORTED_KINDS:
        raise NotImplementedError(
            f"emitter kinds {sorted(kinds - PORTED_KINDS)} not yet ported"
        )
    r = p_ref.shape[0]
    dev = p_ref.device
    u_sel = u3[..., 0]
    u2 = u3[..., 1:3]
    # single-emitter scenes skip the selection search
    if pack.meta["n_emitters"] == 1:
        e = torch.zeros(r, dtype=torch.int64, device=dev)
    else:
        e = torch.clamp(
            torch.searchsorted(pack.emitter_cdf, u_sel.contiguous(), right=True) - 1,
            0, pack.emitter_pmf.shape[0] - 1,
        )
    pmf, kind, rgb = take_fused(e, pack.emitter_pmf, pack.em_kind, pack.em_rgb)

    d = torch.zeros(r, 3, dtype=torch.float32, device=dev)
    dist = torch.full((r,), ENV_DIST, dtype=torch.float32, device=dev)
    pdf = torch.zeros(r, dtype=torch.float32, device=dev)
    value = torch.zeros(r, 3, dtype=torch.float32, device=dev)
    n_l = torch.zeros(r, 3, dtype=torch.float32, device=dev)

    # per-kind branches are gated on the scene's emitter set, as in the
    # reference; a lane takes its emitter's branch
    if AREA in kinds:
        d_a, dist_a, pdf_a, val_a, n_a = _sample_area(pack, e, pmf, rgb, p_ref, u2)
        m = kind == AREA
        d = torch.where(m[..., None], d_a, d)
        dist = torch.where(m, dist_a, dist)
        pdf = torch.where(m, pdf_a, pdf)
        value = torch.where(m[..., None], val_a, value)
        n_l = torch.where(m[..., None], n_a, n_l)
    if CONSTANT in kinds:
        # uniform sphere (reference constant.cpp sampleDirect)
        d_c = warp.square_to_uniform_sphere(u2)
        pdf_c = pmf * INV_FOURPI
        val_c = rgb / torch.clamp(pdf_c, min=1e-12)[..., None]
        m = kind == CONSTANT
        d = torch.where(m[..., None], d_c, d)
        dist = torch.where(m, ENV_DIST, dist)
        pdf = torch.where(m, pdf_c, pdf)
        value = torch.where(m[..., None], val_c, value)
    if pack.meta.get("has_envmap", False):
        d_e, pdf_e = _sample_env_dir(pack, u2)
        le = _env_bilinear(pack, _env_uv_from_dir(pack, d_e))
        pdf_e = pmf * pdf_e
        val_e = torch.where(
            (pdf_e > 1e-12)[..., None], le / torch.clamp(pdf_e, min=1e-12)[..., None], 0.0
        )
        m = kind == ENVMAP
        d = torch.where(m[..., None], d_e, d)
        dist = torch.where(m, ENV_DIST, dist)
        pdf = torch.where(m, pdf_e, pdf)
        value = torch.where(m[..., None], val_e, value)
    return DirectSample(
        d=d, dist=dist, pdf=pdf, value=value,
        delta=torch.zeros(r, dtype=torch.bool, device=dev), n=n_l, kind=kind,
    )


def pdf_direct_area(pack, emit_id, dist, cos_l):
    """Solid-angle pdf of sample_direct having produced this area-light
    hit (MIS on BSDF-sampled rays, reference scene.cpp pdfEmitterDirect)."""
    e = torch.clamp(emit_id, min=0)
    pmf, area = take_fused(e, pack.emitter_pmf, pack.em_area)
    pdf = pmf * (dist * dist) / torch.clamp(cos_l * area, min=1e-12)
    return torch.where((emit_id >= 0) & (cos_l > 1e-6), pdf, 0.0)


def eval_env(pack, d):
    """Radiance of rays escaping to the environment
    (= Scene::evalEnvironment)."""
    if not pack.meta.get("has_env", False):
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    if pack.meta.get("has_envmap", False):
        return _env_bilinear(pack, _env_uv_from_dir(pack, d))
    return pack.em_rgb[pack.meta["env_idx"]].expand(d.shape[:-1] + (3,))


def pdf_direct_env(pack, d):
    """Solid-angle pdf of sample_direct having produced direction d
    toward the environment, emitter PMF included."""
    if not pack.meta.get("has_env", False):
        return torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    pmf = pack.emitter_pmf[pack.meta["env_idx"]]
    return pmf * _env_pdf_dir(pack, d)
