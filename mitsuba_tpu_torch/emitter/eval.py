"""Emitter sampling and evaluation (port of mitsuba_tpu/emitter/eval.py,
the area-light and constant-environment branches of
Scene::sampleEmitterDirect / pdfEmitterDirect / evalEnvironment,
reference src/librender/scene.cpp:828-841).  The returned `value` is
Le/pdf with the emitter-selection probability folded in."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.core.gather import take_fused
from mitsuba_tpu_torch.emitter.plugins import AREA, CONSTANT

ENV_DIST = 1e7  # pseudo-distance for env/directional lights
INV_FOURPI = 0.25 / math.pi
PORTED_KINDS = frozenset({AREA, CONSTANT})


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
    """Radiance of rays escaping to the (constant) environment
    (= Scene::evalEnvironment)."""
    if not pack.meta.get("has_env", False):
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    return pack.em_rgb[pack.meta["env_idx"]].expand(d.shape[:-1] + (3,))


def pdf_direct_env(pack, d):
    """Solid-angle pdf of sample_direct having produced direction d
    toward the (constant) environment, emitter PMF included."""
    if not pack.meta.get("has_env", False):
        return torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    pmf = pack.emitter_pmf[pack.meta["env_idx"]]
    return torch.full(d.shape[:-1], INV_FOURPI, dtype=torch.float32, device=d.device) * pmf
