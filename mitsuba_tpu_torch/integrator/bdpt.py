"""Bidirectional path tracer (port of mitsuba_tpu/integrator/bdpt.py,
reference src/integrators/bdpt/{bdpt.cpp:133, bdpt_proc.cpp:140-268} and
the libbidir path machinery: vertex.h sampleNext, path.cpp randomWalk,
pathsampler.cpp MIS).

Both subpaths are unrolled walks over the whole lane batch: vertex k of
every lane lives in one set of tensors (a dict), and the (s, t)
connection strategies are enumerated on the host, each a vectorized
connection with one shadow ray over all lanes.  As in the reference
(bdpt_proc.cpp:215-241), the s = 1 strategy re-samples the emitter with
sample_direct instead of connecting to the stored light vertex, which is
what makes the delta emitters (point, spot, directional) work
bidirectionally.  The light image (t = 1) splats through the film's
reconstruction filter (film.splat_add).

MIS weights follow Veach's ratio walk over forward and reverse area pdfs,
with per-strategy overrides at the junction vertices.  Participating
media add medium vertices, and every connection carries the
transmittance through null boundaries.  Subpaths are capped at
MTS_BDPT_MAX_EDGES (default 16) edges, with the reference's warning when
maxDepth asks for more; unbounded (-1) scenes unroll
MTS_BDPT_DEFAULT_EDGES (12).

The port draws the reference's random numbers slot for slot: 4 slots per
walk step (the BSDF at slot 2, the s = 1 emitter sample at slot 3), the
light subpath on its own stream, and one transmittance slot per
attenuated connection, counted from 1000 in the reference's order of
strategies (t outer, then s).  Where the reference's one-hot gathers read
a row of zeros for an id out of range, the port clamps the id: every such
lane is masked before its value is read.
"""

from __future__ import annotations

import math
import os

import torch

from mitsuba_tpu_torch.accel.intersect import (
    empty_segments,
    fill_interaction,
    intersect,
    occluded,
)
from mitsuba_tpu_torch.bsdf.eval import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.bsdf.plugins import NULL_BSDF
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import rng, warp
from mitsuba_tpu_torch.core.gather import take_rows
from mitsuba_tpu_torch.emitter import eval as em
from mitsuba_tpu_torch.emitter.plugins import (
    AREA,
    COLLIMATED,
    CONSTANT,
    DIRECTIONAL,
    ENVMAP,
    POINT,
    SPOT,
)
from mitsuba_tpu_torch.integrator import path as _path
from mitsuba_tpu_torch.integrator.ptracer import (
    camera_importance,
    camera_info,
    pick_emitter,
    project,
)
from mitsuba_tpu_torch.integrator.volpath import _attenuated_visibility
from mitsuba_tpu_torch.medium import eval as med_eval
from mitsuba_tpu_torch.scene.texture_eval import mip_footprint, shading_frame, shading_params
from mitsuba_tpu_torch.sensor.plugins import generate_rays

_SLOTS = 4  # RNG slots per walk step
_SLOT_BSDF = 2
_SLOT_NEE = 3
VIS_SLOT_BASE = 1000  # transmittance slots of the connections count from here

# null-BSDF boundaries are not vertices: each walk step resolves up to
# _NULL_CROSSINGS index-matched crossings before the next real vertex
_NULL_CROSSINGS = 3

INV_FOURPI = 0.25 / math.pi
BDPT_KINDS = (AREA, POINT, SPOT, DIRECTIONAL, COLLIMATED, CONSTANT, ENVMAP)
INFINITE_KINDS = (CONSTANT, ENVMAP)
DEFAULT_LANES = 1 << 17  # lanes per chunk (MTS_BDPT_LANES)


def _remap0(x):
    """pdf ratios treat zero (a delta transition) as 1 (Veach / pbrt)."""
    return torch.where(x > 0, x, 1.0)


def _to_area(pdf_w, p_from, p_to, ns_to, medium_to=None):
    """Solid-angle pdf at p_from toward p_to -> area pdf at p_to.  Medium
    vertices have no surface cosine (reference vertex.cpp)."""
    v = p_to - p_from
    d2 = torch.clamp(mm.dot(v, v), min=1e-12)
    w = v / torch.sqrt(d2)[..., None]
    cos = torch.abs(mm.dot(ns_to, w))
    if medium_to is not None:
        cos = torch.where(medium_to, 1.0, cos)
    return pdf_w * cos / d2


def supports_bdpt(pack):
    """The envelope: at least one emitter, all of kinds in BDPT_KINDS
    (media are supported)."""
    kinds = pack.meta.get("emitter_kinds", ())
    return pack.meta["n_emitters"] > 0 and all(k in BDPT_KINDS for k in kinds)


# -----------------------------------------------------------------------------
# subpath random walks (Path::randomWalk, path.cpp)
# -----------------------------------------------------------------------------

def _walk(pack, o0, d0, beta0, pdf_w0, lane, sidx, seed, n_steps, present, delta0,
          planar0=None, med0=None, u_bsdf=None, u_med=None, stats=None):
    """Unrolled random walk of up to n_steps vertices, surface and medium
    (reference bdpt.py:114-343).

    o0/d0: the start ray; beta0: throughput along it; pdf_w0: the
    solid-angle pdf of d0 at its origin; delta0: whether d0's generating
    distribution is a delta in direction.  Returns a list of n_steps
    vertex dicts: valid, p, ns, ng, wi (unit, toward the predecessor), sp
    (shading parameters), beta (throughput into the vertex), pdf_fwd
    (area), pdf_rev (area, from the successor; 0 where unknown or delta),
    delta (the transition sampled at the vertex is a Dirac lobe), emit,
    is_medium, med (the medium at the vertex), med_in, med_ex.  u_bsdf(k)
    and u_med(k, nn) give explicit primary samples in place of the
    counter RNG (homogeneous media only).  stats["rays"] counts the
    closest-hit rays of live lanes."""
    has_media = pack.meta.get("has_media", False)
    r = o0.shape[0]
    dev = o0.device
    verts = []
    o, d = o0, d0
    beta = beta0
    pdf_w = pdf_w0
    active = beta0.amax(dim=-1) > 0
    prev_p = o0
    prev_delta_transition = delta0
    cur_med = (
        med0 if med0 is not None
        else torch.full((r,), pack.meta.get("camera_medium", -1), dtype=torch.int32, device=dev)
    )
    seed_m = rng.stream_seed(seed, rng.STREAM_MEDIUM_DIST)
    zeros = torch.zeros(r, dtype=torch.bool, device=dev)

    for k in range(n_steps):
        if has_media:
            o_cur = o
            unresolved = active
            medium_evt = surf_evt = escaped = zeros
            its = None
            p_v = torch.zeros(r, 3, dtype=torch.float32, device=dev)
            for nn in range(_NULL_CROSSINGS):
                if stats is not None:
                    stats["rays"] = stats["rays"] + unresolved.sum()
                hit_n = intersect(pack, o_cur, d)
                its_n = fill_interaction(pack, o_cur, d, hit_n)
                t_seg = torch.where(hit_n.valid, hit_n.t, 1e7)
                u_m = (
                    u_med(k, nn) if u_med is not None
                    else rng.rand4(lane, sidx, (k * _NULL_CROSSINGS + nn) * 2, seed_m)
                )
                ms = med_eval.sample_distance(
                    pack, cur_med, o_cur, d, t_seg, u_m[..., :3], lane, sidx,
                    k * _NULL_CROSSINGS + nn, seed,
                )
                beta = beta * torch.where(unresolved[..., None], ms.weight, 1.0)
                med_n = unresolved & ms.is_medium
                is_null = take_rows(pack.mat_type, torch.clamp(its_n.mat, min=0)) == NULL_BSDF
                null_n = unresolved & ~med_n & its_n.valid & is_null
                surf_n = unresolved & ~med_n & its_n.valid & ~is_null
                sel = med_n | surf_n
                if its is None:
                    its = its_n
                else:
                    its = type(its)(*(
                        torch.where(sel.reshape(sel.shape + (1,) * (a.ndim - 1)), a, b)
                        for a, b in zip(its_n, its)
                    ))
                p_v = torch.where(
                    med_n[..., None], o_cur + d * ms.t[..., None],
                    torch.where(surf_n[..., None], its_n.p, p_v),
                )
                medium_evt = medium_evt | med_n
                surf_evt = surf_evt | surf_n
                escaped = escaped | (unresolved & ~med_n & ~its_n.valid)
                # cross null boundaries: advance and switch media
                entering = mm.dot(d, its_n.ng) < 0
                cur_med = torch.where(
                    null_n, torch.where(entering, its_n.med_in, its_n.med_ex), cur_med
                )
                o_cur = torch.where(null_n[..., None], its_n.p + d * 1e-4, o_cur)
                unresolved = null_n
            valid = medium_evt | surf_evt
            hit_valid = ~escaped
        else:
            if stats is not None:
                stats["rays"] = stats["rays"] + active.sum()
            hit = intersect(pack, o, d)
            its = fill_interaction(pack, o, d, hit)
            medium_evt = zeros
            surf_evt = active & its.valid
            valid = surf_evt
            p_v = its.p
            hit_valid = its.valid

        frame = shading_frame(pack, its)
        wi_l = frame.to_local(its.wi_world)
        sp = shading_params(pack, its.mat, its.uv, mip_footprint(pack, its), its=its)

        pdf_fwd = torch.where(
            prev_delta_transition, 0.0,
            _to_area(pdf_w, prev_p, p_v, its.ns, medium_to=medium_evt),
        )
        # the raw solid-angle density of the generating transition (an
        # environment escape has no position to convert to)
        pdf_w_in = torch.where(prev_delta_transition, 0.0, pdf_w)
        if k == 0 and planar0 is not None:
            # directional and infinite emitters: the disk position picks
            # this vertex, a planar density projected onto the surface
            cosg = torch.where(medium_evt, 1.0, torch.abs(mm.dot(its.ns, d)))
            pdf_fwd = torch.where(planar0 > 0, planar0 * cosg, pdf_fwd)

        # direction sampling: the BSDF at surfaces, the phase in media
        u_b = (
            u_bsdf(k) if u_bsdf is not None
            else rng.rand4(lane, sidx, k * _SLOTS + _SLOT_BSDF, seed)
        )
        bs = bsdf_sample(sp, wi_l, u_b[..., :2], u_b[..., 2], present)
        d_surf = frame.to_world(bs.wo)
        if has_media:
            d_ph, ph_pdf, ph_w = med_eval.phase_sample(pack, cur_med, d, u_b[..., :2], p=p_v)
            d_new = torch.where(medium_evt[..., None], d_ph, d_surf)
            step_pdf_w = torch.where(medium_evt, ph_pdf, bs.pdf)
            step_delta = torch.where(medium_evt, False, bs.delta)
            step_w = torch.where(medium_evt[..., None], ph_w[..., None].expand(-1, 3), bs.weight)
        else:
            d_new, step_pdf_w, step_delta, step_w = d_surf, bs.pdf, bs.delta, bs.weight

        v = dict(
            valid=valid, p=p_v, ns=its.ns, ng=its.ng, wi=its.wi_world, sp=sp, beta=beta,
            pdf_fwd=pdf_fwd, pdf_rev=torch.zeros(r, dtype=torch.float32, device=dev),
            delta=step_delta, emit=torch.where(medium_evt, -1, its.emit),
            is_medium=medium_evt, med=cur_med, med_in=its.med_in, med_ex=its.med_ex,
            _pdf_w_in=pdf_w_in, _hit_valid=hit_valid,
        )

        # the predecessor's reverse pdf: this vertex scattering back
        # toward it (vertex.h pdf[1 - mode])
        rev_w = torch.where(bs.delta, 0.0, bsdf_pdf(sp, bs.wo, wi_l, present))
        if has_media:
            rev_w = torch.where(
                medium_evt, med_eval.phase_pdf(pack, cur_med, d_new, its.wi_world, p=p_v), rev_w
            )
        if k > 0:
            prev = verts[k - 1]
            prev["pdf_rev"] = torch.where(
                valid,
                _to_area(rev_w, p_v, prev["p"], prev["ns"], medium_to=prev["is_medium"]),
                prev["pdf_rev"],
            )
        else:
            v["_rev_w_to_origin"] = rev_w
        verts.append(v)

        beta = beta * torch.where(valid[..., None], step_w, 0.0)
        prev_p = p_v
        prev_delta_transition = step_delta
        pdf_w = step_pdf_w
        if has_media:
            # medium transitions at surface crossings (null BSDFs too)
            new_med = torch.where(mm.dot(d_new, its.ng) < 0, its.med_in, its.med_ex)
            cur_med = torch.where(surf_evt, new_med, cur_med)
            o = torch.where(medium_evt[..., None], p_v, _path._offset_ray(its.p, its.ng, d_new))
        else:
            o = _path._offset_ray(its.p, its.ng, d_new)
        d = d_new
        active = valid & (beta.amax(dim=-1) > 0)
    return verts


# -----------------------------------------------------------------------------
# the light side (AbstractEmitter::samplePosition / sampleDirection)
# -----------------------------------------------------------------------------

def _sample_light_vertex(pack, lane, sidx, seed, u01=None):
    """Light vertex 0 and the first emission ray, for every kind in
    BDPT_KINDS (reference bdpt.py:352-563).  Returns (v0, o1, d1, beta1,
    pdf_w1, delta1, planar0, med0).  v0 carries beta = Le or I / (pmf *
    pdf_pos), pdf_fwd = pmf * pdf_pos (a mass for delta positions),
    hittable (the s' = 0 strategy exists), and a unit normal ns for the
    area-measure conversions.  Each kind's table rows are gathered with
    the lane's emitter id, which is in range for every kind; a kind's
    values land only on its own lanes."""
    r = lane.shape[0]
    dev = lane.device
    if u01 is None:
        u = rng.rand4(lane, sidx, 0, seed)
        u2 = rng.rand4(lane, sidx, 1, seed)
    else:
        u, u2 = u01
    kinds = pack.meta.get("emitter_kinds", ())

    if pack.meta["n_emitters"] == 1:
        e = torch.zeros(r, dtype=torch.int64, device=dev)
    else:
        e = pick_emitter(pack, u[..., 0])
    pmf, kind, rgb = pack.emitter_pmf[e], pack.em_kind[e], pack.em_rgb[e]

    def f32(*shape, fill=0.0):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(r, 3)
    st = dict(
        p0=f32(r, 3), n0=z_axis, beta0=f32(r, 3), pdf_pos=f32(r, fill=1.0), d1=z_axis,
        pdf_w1=f32(r, fill=1.0), beta1=f32(r, 3),
        delta1=torch.zeros(r, dtype=torch.bool, device=dev),
        hittable=torch.zeros(r, dtype=torch.bool, device=dev),
    )
    med0 = torch.full((r,), pack.meta.get("camera_medium", -1), dtype=torch.int32, device=dev)

    def put(mask, **kw):
        for k_, v_ in kw.items():
            m = mask[..., None] if st[k_].ndim == 2 else mask
            st[k_] = torch.where(m, v_, st[k_])

    true_r = torch.ones(r, dtype=torch.bool, device=dev)
    # ---- area: a triangle through the emitter's area CDF, a cosine
    # direction (cos / pdf_dir = pi) ----
    if AREA in kinds or not kinds:
        em_lo, em_hi, area = pack.em_tri_lo[e], pack.em_tri_hi[e], pack.em_area[e]
        # a non-area lane's empty segment [0, 0) reads slot 0
        tri_slot = em._searchsorted_segment(pack.area_tri_cdf, u[..., 1], em_lo, em_hi)
        tri = pack.area_tri_idx[tri_slot]
        bary = warp.square_to_uniform_triangle(u[..., 2:4])
        e1, e2 = pack.tri_e1[tri], pack.tri_e2[tri]
        p_a = pack.tri_v0[tri] + bary[..., 0:1] * e1 + bary[..., 1:2] * e2
        n_a = mm.normalize(mm.cross(e1, e2))
        pp_a = pmf / torch.clamp(area, min=1e-12)
        b0_a = rgb / torch.clamp(pp_a, min=1e-12)[..., None]
        d_l = warp.square_to_cosine_hemisphere(u2[..., 0:2])
        d_a = mm.Frame.from_normal(n_a).to_world(d_l)
        pw_a = torch.clamp(mm.cos_theta(d_l), min=1e-12) / math.pi
        put(kind == AREA, p0=p_a, n0=n_a, beta0=b0_a, pdf_pos=pp_a, d1=d_a, pdf_w1=pw_a,
            beta1=b0_a * math.pi, hittable=true_r)
        if pack.meta.get("has_media", False):
            med0 = torch.where(kind == AREA, pack.tri_med_ex[tri], med0)

    if POINT in kinds or SPOT in kinds or COLLIMATED in kinds:
        em_pos, em_dir, cc, cb = (pack.em_pos[e], pack.em_dir[e], pack.em_cos_cutoff[e],
                                  pack.em_cos_beam[e])
        b0_p = rgb / torch.clamp(pmf, min=1e-12)[..., None]
        # ---- point: uniform sphere emission ----
        if POINT in kinds:
            d_p = warp.square_to_uniform_sphere(u2[..., 0:2])
            put(kind == POINT, p0=em_pos, n0=d_p, beta0=b0_p, pdf_pos=pmf, d1=d_p,
                pdf_w1=f32(r, fill=INV_FOURPI), beta1=b0_p / INV_FOURPI)
        # ---- spot: uniform cone up to the cutoff, linear falloff ----
        if SPOT in kinds:
            d_sl = warp.square_to_uniform_cone(u2[..., 0:2], cc)
            d_s = mm.Frame.from_normal(em_dir).to_world(d_sl)
            pw_s = warp.square_to_uniform_cone_pdf(cc)
            fall = em.spot_falloff(mm.cos_theta(d_sl), cc, cb)
            put(kind == SPOT, p0=em_pos, n0=em_dir, beta0=b0_p, pdf_pos=pmf, d1=d_s,
                pdf_w1=pw_s, beta1=b0_p * (fall / torch.clamp(pw_s, min=1e-12))[..., None])
        # ---- collimated beam: Dirac position and direction; only the
        # light-transport strategies (s >= 2, t = 1) reach it, as in the
        # reference, whose sampleDirect always fails (collimated.cpp) ----
        if COLLIMATED in kinds:
            put(kind == COLLIMATED, p0=em_pos, n0=em_dir, beta0=b0_p, pdf_pos=pmf, d1=em_dir,
                pdf_w1=f32(r, fill=1.0), beta1=b0_p, delta1=true_r)

    # ---- directional: a disk position at the scene bound.  The delta
    # direction is not flagged a Dirac transition: the disk position picks
    # the first hit, so vertex 1 carries the planar density 1 / (pi R^2)
    # projected onto its surface (reference path.cpp:305-329) ----
    planar0 = f32(r)
    center = torch.tensor(pack.meta["scene_center"], dtype=torch.float32, device=dev)
    rad = pack.meta["scene_radius"]
    pp_planar = 1.0 / (math.pi * rad * rad)
    if DIRECTIONAL in kinds:
        em_dir = pack.em_dir[e]
        disk = warp.square_to_uniform_disk_concentric(u2[..., 0:2]) * rad
        off = mm.Frame.from_normal(em_dir).to_world(
            torch.cat([disk, f32(r, 1)], dim=-1)
        )
        p_d = center[None, :] - em_dir * (1.5 * rad) + off
        pp_d = pmf * pp_planar
        b_d = rgb / torch.clamp(pp_d, min=1e-12)[..., None]
        put(kind == DIRECTIONAL, p0=p_d, n0=em_dir, beta0=b_d, pdf_pos=pmf, d1=em_dir,
            pdf_w1=f32(r, fill=1.0), beta1=b_d)
        planar0 = torch.where(kind == DIRECTIONAL, pp_planar, 0.0)

    # ---- infinite emitters (constant, envmap): the emission direction
    # (uniform sphere, or the image's alias table), then a disk position
    # at the scene bound; v0.pdf_fwd is the directional density and
    # vertex 1 gets the planar disk density ----
    is_inf = torch.zeros(r, dtype=torch.bool, device=dev)
    if CONSTANT in kinds or ENVMAP in kinds:
        if pack.meta.get("has_envmap", False):
            d_to_env, pdf_dir = em._sample_env_dir(pack, u2[..., 0:2])
            le = em._env_bilinear(pack, em._env_uv_from_dir(pack, d_to_env))
        else:
            d_to_env = warp.square_to_uniform_sphere(u2[..., 0:2])
            pdf_dir = f32(r, fill=em.INV_FOURPI)
            le = rgb
        w_in = -d_to_env  # the emission direction, into the scene
        disk = warp.square_to_uniform_disk_concentric(u[..., 2:4]) * rad
        off = mm.Frame.from_normal(w_in).to_world(torch.cat([disk, f32(r, 1)], dim=-1))
        p_e = center[None, :] + d_to_env * (1.5 * rad) + off
        denom = torch.clamp(pmf * pdf_dir * pp_planar, min=1e-20)
        for kc in INFINITE_KINDS:
            if kc in kinds:
                sel = kind == kc
                put(sel, p0=p_e, n0=w_in,
                    beta0=le / torch.clamp(pmf * pdf_dir, min=1e-20)[..., None],
                    pdf_pos=pmf * pdf_dir, d1=w_in, pdf_w1=f32(r, fill=1.0),
                    beta1=le / denom[..., None], hittable=true_r)
                planar0 = torch.where(sel, pp_planar, planar0)
                is_inf = is_inf | sel

    p0, n0, d1 = st["p0"], st["n0"], st["d1"]
    false_r = torch.zeros(r, dtype=torch.bool, device=dev)
    v0 = dict(
        valid=true_r, p=p0, ns=n0, emit=e, kind=kind, beta=st["beta0"], pdf_fwd=st["pdf_pos"],
        pdf_rev=f32(r), delta=st["delta1"], hittable=st["hittable"], is_inf=is_inf,
        is_medium=false_r, ng=n0, med=med0, med_in=med0, med_ex=med0,
    )
    o1 = p0 + d1 * 1e-4 + torch.where((kind == AREA)[..., None], n0 * 1e-4, 0.0)
    return v0, o1, d1, st["beta1"], st["pdf_w1"], st["delta1"], planar0, med0


def _emission_dir_pdf_w(pack, kind, e, n_l, d_out, kinds):
    """Solid-angle pdf of the emitter's direction sampling along d_out
    (the competing emission strategies of MIS).  Delta directions give 0
    (their strategies are gated by the delta flags)."""
    pdf = torch.zeros(kind.shape, dtype=torch.float32, device=kind.device)
    if AREA in kinds or not kinds:
        pdf = torch.where(kind == AREA, torch.clamp(mm.dot(n_l, d_out), min=0.0) / math.pi, pdf)
    if POINT in kinds:
        pdf = torch.where(kind == POINT, INV_FOURPI, pdf)
    if SPOT in kinds:
        em_dir, cc = pack.em_dir[e], pack.em_cos_cutoff[e]
        inside = mm.dot(em_dir, d_out) >= cc
        pdf = torch.where(
            kind == SPOT, torch.where(inside, warp.square_to_uniform_cone_pdf(cc), 0.0), pdf
        )
    return pdf


# -----------------------------------------------------------------------------
# MIS (the Veach ratio walk with junction overrides, bdpt_proc.cpp miWeight)
# -----------------------------------------------------------------------------

def _mis_weight(s, t, cam, light, over_rev, false_arr):
    """1 / (1 + the sum of the pdf ratios of all competing (s', t')
    strategies).  cam / light: vertex dict lists; over_rev: {(side, k):
    pdf_rev} overrides at this strategy's junction vertices."""

    def rev(side, k, verts):
        return over_rev.get((side, k), verts[k]["pdf_rev"])

    def dlt(side, k, verts):
        # junction vertices count as connectible (delta forced off)
        if side == "c" and k == t - 2:
            return false_arr
        if side == "l" and k == s - 1:
            return false_arr
        return verts[k]["delta"]

    sum_ri = torch.zeros(false_arr.shape, dtype=torch.float32, device=false_arr.device)
    # the camera side: strategies that shorten the camera subpath
    ri = torch.ones_like(sum_ri)
    for k in range(t - 2, -1, -1):
        ri = ri * _remap0(rev("c", k, cam)) / _remap0(cam[k]["pdf_fwd"])
        nd_i = ~dlt("c", k, cam)
        nd_prev = ~dlt("c", k - 1, cam) if k >= 1 else ~false_arr
        sum_ri = sum_ri + torch.where(nd_i & nd_prev, ri, 0.0)
    # the light side
    ri = torch.ones_like(sum_ri)
    for k in range(s - 1, -1, -1):
        ri = ri * _remap0(rev("l", k, light)) / _remap0(light[k]["pdf_fwd"])
        nd_i = ~dlt("l", k, light)
        if k >= 1:
            nd_prev = ~dlt("l", k - 1, light)
        else:
            # k = 0: the competing strategy is s' = 0 (the camera path hits
            # the emitter), which exists for hittable emitters only
            nd_prev = light[0].get("hittable", ~false_arr)
        sum_ri = sum_ri + torch.where(nd_i & nd_prev, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


# -----------------------------------------------------------------------------
# scattering at a vertex: the BSDF at a surface, the phase in a medium
# (PathVertex::eval / evalPdf, vertex.cpp)
# -----------------------------------------------------------------------------

def _vertex_frame(v):
    return mm.Frame.from_normal(v["ns"])


def _v_f(pack, v, wo_w, present):
    """Scattering throughput f(wi -> wo), |cos_o| folded in at surfaces
    (bsdf_eval's convention); the phase value at medium vertices (its
    cosine cancels in the generalized geometric term)."""
    fr = _vertex_frame(v)
    f_s = bsdf_eval(v["sp"], fr.to_local(v["wi"]), fr.to_local(wo_w), present)
    if pack.meta.get("has_media", False):
        f_m = med_eval.phase_eval(pack, v["med"], -v["wi"], wo_w, p=v["p"])
        return torch.where(v["is_medium"][..., None], f_m[..., None].expand(-1, 3), f_s)
    return f_s


def _v_pdf(pack, v, wi_w, wo_w, present):
    """Solid-angle density of sampling wo_w at vertex v when arriving
    from wi_w (both unit, pointing away from v)."""
    fr = _vertex_frame(v)
    p_s = bsdf_pdf(v["sp"], fr.to_local(wi_w), fr.to_local(wo_w), present)
    if pack.meta.get("has_media", False):
        p_m = med_eval.phase_pdf(pack, v["med"], -wi_w, wo_w, p=v["p"])
        return torch.where(v["is_medium"], p_m, p_s)
    return p_s


# -----------------------------------------------------------------------------
# one bdpt chunk
# -----------------------------------------------------------------------------

def bdpt_max_edges(integ):
    """The subpath edge budget of a bdpt-family run: maxDepth, capped at
    MTS_BDPT_MAX_EDGES (16) with a warning; MTS_BDPT_DEFAULT_EDGES (12)
    for an unbounded maxDepth."""
    cap = int(os.environ.get("MTS_BDPT_MAX_EDGES", 16))
    default_edges = min(int(os.environ.get("MTS_BDPT_DEFAULT_EDGES", 12)), cap)
    max_edges = integ.max_depth if integ.max_depth > 0 else default_edges
    if max_edges > cap:
        print(f"[bdpt] maxDepth {max_edges} capped to {cap} edges (MTS_BDPT_MAX_EDGES)")
        max_edges = cap
    return max_edges


def primary_dims(max_edges, has_media=False):
    """The primary-sample dimensions of one bidirectional sample (the
    explicit-U layout chunk_fn reads): [0:2] film position, [2:4] lens;
    3 per step of the camera BSDF; 3 per step of the s = 1 emitter
    sample; 6 for the light vertex; 3 per step of the light BSDF; with
    homogeneous media, 2 per (step, null crossing) of distance sampling,
    the camera walk then the light walk."""
    n = 4 + 3 * max_edges + 3 * max_edges + 6 + 3 * (max_edges - 1)
    if has_media:
        n += 2 * _NULL_CROSSINGS * (max_edges + max(max_edges - 1, 1))
    return n


def make_bdpt_chunk(pack, integ, sen, w, h, seed, exclude_direct=False):
    """Returns chunk_fn(lane, sidx, U=None) -> (L [r, 3], splats: a list of
    (pos [r, 2], val [r, 3], ok [r])): the per-lane bdpt estimate and the
    light-image splats.  chunk_fn.stats["rays"] accumulates the
    closest-hit rays of live walk lanes and the shadow rays of
    connections whose vertices are both live (an int64 tensor).

    With U [r, primary_dims(max_edges)] every sampling decision, the film
    position U[:, 0:2] included, comes from the explicit primary-sample
    tensor instead of the counter RNG: the bidirectional path sampler the
    chain family (pssmlt) re-traces mutations through (reference
    pathsampler.cpp:93-127).  Scenes with heterogeneous media take the
    counter RNG only.  exclude_direct drops the strategies of at most 2
    edges (separateDirect)."""
    present = pack.meta["present_types"]
    kinds = pack.meta.get("emitter_kinds", ())
    max_edges = bdpt_max_edges(integ)
    n_cam = n_light = max_edges
    has_media = pack.meta.get("has_media", False)
    has_inf = any(kc in kinds for kc in INFINITE_KINDS)
    sampler_rec = sen.sampler

    def _gate(edges):
        return not exclude_direct or edges > 2

    def chunk_fn(lane, sidx, U=None):
        r = lane.shape[0]
        dev = lane.device
        cam_info = camera_info(sen, w, h, dev)
        cam_pos = cam_info[0]
        cam_packed = sen.pack(w, h, dev)
        false_arr = torch.zeros(r, dtype=torch.bool, device=dev)
        vis_slot = [VIS_SLOT_BASE]  # one transmittance slot per connection
        stats = chunk_fn.stats

        if U is not None:
            if pack.meta.get("n_het", 0) > 0:
                raise NotImplementedError(
                    "primary-driven bdpt sampling requires homogeneous media "
                    "(heterogeneous delta tracking draws unbounded randomness "
                    "that cannot live in a finite primary vector)"
                )
            off_cam = 4
            off_nee = off_cam + 3 * n_cam
            off_li = off_nee + 3 * n_cam
            off_lb = off_li + 6
            zero1 = torch.zeros(r, 1, dtype=torch.float32, device=dev)

            def u3(off):
                return torch.cat([U[:, off:off + 3], zero1], dim=-1)

            def u2p(off):
                return torch.cat([U[:, off:off + 2], zero1, zero1], dim=-1)

            u_cam_bsdf = lambda k: u3(off_cam + 3 * k)  # noqa: E731
            u_nee = lambda t: u3(off_nee + 3 * (t - 2))  # noqa: E731
            u_light01 = (U[:, off_li:off_li + 4], u2p(off_li + 4))
            u_light_bsdf = lambda k: u3(off_lb + 3 * k)  # noqa: E731
            u_cam_med = u_light_med = None
            if has_media:
                off_cmed = off_lb + 3 * (max_edges - 1)
                off_lmed = off_cmed + 2 * _NULL_CROSSINGS * n_cam
                u_cam_med = lambda k, nn: u2p(off_cmed + 2 * (k * _NULL_CROSSINGS + nn))  # noqa: E731
                u_light_med = lambda k, nn: u2p(off_lmed + 2 * (k * _NULL_CROSSINGS + nn))  # noqa: E731
        else:
            u_cam_bsdf = u_nee = u_light01 = u_light_bsdf = u_cam_med = u_light_med = None

        def conn_tr(v_from, d_c, dist, live):
            """Visibility (and with media the transmittance) of a
            connection edge from v_from toward d_c (reference
            bdpt_proc.cpp:266-268).  Returns [r, 3]."""
            stats["rays"] = stats["rays"] + live.sum()
            o_sh = _path._offset_ray(v_from["p"], v_from["ng"], d_c)
            if has_media:
                o_sh = torch.where(v_from["is_medium"][..., None], v_from["p"], o_sh)
            # a lane whose vertices are not both live may hold inf or NaN (a
            # vertex past an escape): it traces an empty segment instead,
            # whose result no strategy reads
            o_sh, d_c, dist = empty_segments(pack, live, o_sh, d_c, dist)
            if not has_media:
                occ = occluded(pack, o_sh, d_c, dist * (1.0 - 1e-3))
                return torch.where(occ[..., None], 0.0, 1.0)
            med_c = torch.where(
                v_from["is_medium"], v_from["med"],
                torch.where(mm.dot(d_c, v_from["ng"]) < 0, v_from["med_in"], v_from["med_ex"]),
            )
            vis_slot[0] += 1
            tr, _ = _attenuated_visibility(pack, o_sh, d_c, dist, med_c, lane, sidx,
                                           vis_slot[0], seed)
            return tr

        # ---- the camera subpath ----
        if U is not None:
            pos01, lens_u = U[:, 0:2], U[:, 2:4]
        else:
            jitter = sampler_rec.pixel_sample(lane, sidx, sampler_rec.sample_count)
            x = (lane % w).to(torch.float32) + jitter[..., 0]
            y = (lane // w).to(torch.float32) + jitter[..., 1]
            pos01 = torch.stack([x / w, y / h], dim=-1)
            lens_u = sampler_rec.lens_sample(lane, sidx)
        o0, d0 = generate_rays(cam_packed, pos01, lens_u)
        cam = _walk(
            pack, o0, d0, torch.ones(r, 3, dtype=torch.float32, device=dev),
            camera_importance(cam_info, d0), lane, sidx, seed, n_cam, present,
            delta0=false_arr, u_bsdf=u_cam_bsdf, u_med=u_cam_med, stats=stats,
        )

        # ---- the light subpath ----
        seed_l = rng.stream_seed(seed, rng.STREAM_LIGHT)
        lv0, o1, d1, beta1, pdf_w1, delta1, planar0, lmed0 = _sample_light_vertex(
            pack, lane, sidx, seed_l, u01=u_light01
        )
        lwalk = _walk(
            pack, o1, d1, beta1, pdf_w1, lane, sidx, seed_l, max(n_light - 1, 1), present,
            delta0=delta1, planar0=planar0, med0=lmed0, u_bsdf=u_light_bsdf, u_med=u_light_med,
            stats=stats,
        )
        # light vertex 0's reverse pdf from vertex 1's BSDF: area measure
        # for finite emitters, solid angle for infinite ones
        rw = lwalk[0]["_rev_w_to_origin"]
        rev_area = _to_area(rw, lwalk[0]["p"], lv0["p"], lv0["ns"])
        lv0["pdf_rev"] = torch.where(
            lwalk[0]["valid"], torch.where(lv0["is_inf"], rw, rev_area), 0.0
        )
        light = [lv0] + lwalk

        L = torch.zeros(r, 3, dtype=torch.float32, device=dev)
        splats = []
        rad = pack.meta["scene_radius"]
        planar = 1.0 / (math.pi * rad * rad)

        # ================= strategy enumeration =================
        for t in range(2, n_cam + 2):  # camera-side vertices, camera included
            pt = cam[t - 2]

            # ---- s = 0 (environment): the camera path escapes to an
            # infinite emitter; the escape direction is the emitter vertex,
            # so its pdfs stay in solid angle ----
            if t - 1 <= max_edges and _gate(t - 1) and has_inf:
                k = t - 2
                alive = cam[k]["beta"].amax(dim=-1) > 0
                prev_ok = cam[k - 1]["valid"] if k >= 1 else ~false_arr
                esc = ~cam[k]["_hit_valid"] & alive & prev_ok
                d_esc = -cam[k]["wi"]
                le_env = em.eval_env(pack, d_esc)
                pmf_env = pack.emitter_pmf[pack.meta["env_idx"]]
                cam_env = list(cam)
                cam_env[k] = dict(cam[k], pdf_fwd=cam[k]["_pdf_w_in"])
                over = {("c", k): pmf_env * em._env_pdf_dir(pack, d_esc)}
                if t >= 3:
                    over[("c", t - 3)] = planar * torch.abs(mm.dot(cam[t - 3]["ns"], d_esc))
                w_mis = _mis_weight(0, t, cam_env, light, over, false_arr)
                L = L + torch.where(esc[..., None], cam[k]["beta"] * le_env * w_mis[..., None], 0.0)

            # ---- s = 0: the camera path hits an area light (t - 1 edges) ----
            if 1 <= t - 1 <= max_edges and _gate(t - 1) and (AREA in kinds or not kinds):
                cos_e = mm.dot(pt["ns"], pt["wi"])
                hit_l = pt["valid"] & (pt["emit"] >= 0) & (cos_e > 0)
                e = torch.clamp(pt["emit"], min=0)
                le = pack.em_rgb[e]
                over = {("c", t - 2): pack.emitter_pmf[e] / torch.clamp(pack.em_area[e], min=1e-12)}
                if t >= 3:
                    ptm = cam[t - 3]
                    pdf_w = torch.clamp(cos_e, min=0.0) / math.pi
                    over[("c", t - 3)] = _to_area(pdf_w, pt["p"], ptm["p"], ptm["ns"])
                w_mis = _mis_weight(0, t, cam, light, over, false_arr)
                L = L + torch.where(hit_l[..., None], pt["beta"] * le * w_mis[..., None], 0.0)

            # ---- s = 1: re-sample the emitter (sampleDirect NEE,
            # bdpt_proc.cpp:215-241), every emitter kind ----
            if t <= max_edges and _gate(t):
                u_n = (
                    u_nee(t) if u_nee is not None
                    else rng.rand4(lane, sidx, (t - 2) * _SLOTS + _SLOT_NEE, seed)
                )
                ds = em.sample_direct(pack, pt["p"], u_n[..., 0:3])
                f_pt = _v_f(pack, pt, ds.d, present)
                tr = conn_tr(pt, ds.d, ds.dist, pt["valid"])
                contrib = pt["beta"] * f_pt * ds.value * tr
                ok = pt["valid"] & (ds.pdf > 0) & (contrib.amax(dim=-1) > 0)

                # a stand-in light vertex for the ratio walk: the sampled point
                p_l = pt["p"] + ds.d * ds.dist[..., None]
                n_l = torch.where(
                    torch.abs(ds.n).amax(dim=-1, keepdim=True) > 1e-6, ds.n, -ds.d
                )
                # the NEE pdf in area measure at the light (a mass for
                # deltas, solid angle for infinite emitters)
                inf_nee = false_arr
                for kc in INFINITE_KINDS:
                    if kc in kinds:
                        inf_nee = inf_nee | (ds.kind == kc)
                pdf_l_area = torch.where(
                    ds.delta | inf_nee, ds.pdf, _to_area(ds.pdf, pt["p"], p_l, n_l)
                )
                fake0 = dict(
                    valid=ok, p=p_l, ns=n_l, beta=ds.value, pdf_fwd=pdf_l_area,
                    pdf_rev=torch.zeros(r, dtype=torch.float32, device=dev), delta=false_arr,
                    hittable=~ds.delta, is_inf=inf_nee, is_medium=false_arr,
                )
                over = {}
                # the camera junction seen from the light: the emission pdf
                # (a spot's cone needs the emitter sample_direct picked)
                if SPOT in kinds:
                    if pack.meta["n_emitters"] == 1:
                        e_sel = torch.zeros(r, dtype=torch.int64, device=dev)
                    else:
                        e_sel = pick_emitter(pack, u_n[..., 0])
                else:
                    e_sel = torch.zeros(r, dtype=torch.int64, device=dev)
                em_pdf_w = _emission_dir_pdf_w(pack, ds.kind, e_sel, n_l, -ds.d, kinds)
                over_ct2 = _to_area(em_pdf_w, p_l, pt["p"], pt["ns"], medium_to=pt["is_medium"])
                if DIRECTIONAL in kinds or has_inf:
                    # directional and infinite emitters share the planar
                    # disk density onto the receiving surface
                    plan_sel = ds.kind == DIRECTIONAL
                    for kc in INFINITE_KINDS:
                        if kc in kinds:
                            plan_sel = plan_sel | (ds.kind == kc)
                    cos_pt = torch.where(pt["is_medium"], 1.0, torch.abs(mm.dot(pt["ns"], ds.d)))
                    over_ct2 = torch.where(plan_sel, planar * cos_pt, over_ct2)
                over[("c", t - 2)] = over_ct2
                # the light point seen from pt (scattering pdf; solid angle
                # for infinite emitters)
                pdf_w3 = _v_pdf(pack, pt, pt["wi"], ds.d, present)
                over[("l", 0)] = torch.where(
                    ds.delta, 0.0,
                    torch.where(inf_nee, pdf_w3, _to_area(pdf_w3, pt["p"], p_l, n_l)),
                )
                if t >= 3:
                    ptm = cam[t - 3]
                    pdf_w4 = _v_pdf(pack, pt, ds.d, pt["wi"], present)
                    over[("c", t - 3)] = _to_area(pdf_w4, pt["p"], ptm["p"], ptm["ns"],
                                                  medium_to=ptm["is_medium"])
                w_mis = _mis_weight(1, t, cam, [fake0], over, false_arr)
                L = L + torch.where(ok[..., None], contrib * w_mis[..., None], 0.0)

            # ---- s >= 2, t >= 2: connections (s + t - 1 edges) ----
            for s in range(2, len(light) + 1):
                if s + t - 1 > max_edges:
                    break
                qs = light[s - 1]
                v = qs["p"] - pt["p"]
                d2 = torch.clamp(mm.dot(v, v), min=1e-12)
                dist = torch.sqrt(d2)
                dc = v / dist[..., None]

                f_pt = _v_f(pack, pt, dc, present)
                f_qs = qs["beta"] * _v_f(pack, qs, -dc, present)
                geo = 1.0 / d2
                tr = conn_tr(pt, dc, dist, pt["valid"] & qs["valid"])
                contrib = pt["beta"] * f_pt * f_qs * geo[..., None] * tr
                ok = qs["valid"] & pt["valid"] & (contrib.amax(dim=-1) > 0)

                # the junction pdf overrides
                over = {}
                pdf_w = _v_pdf(pack, qs, qs["wi"], -dc, present)
                over[("c", t - 2)] = _to_area(pdf_w, qs["p"], pt["p"], pt["ns"],
                                              medium_to=pt["is_medium"])
                # qs - 1 seen from qs (now arriving from pt); light vertex 0
                # of an infinite emitter keeps solid angle
                qsm = light[s - 2]
                pdf_w2 = _v_pdf(pack, qs, -dc, qs["wi"], present)
                rev_sm = _to_area(pdf_w2, qs["p"], qsm["p"], qsm["ns"], medium_to=qsm["is_medium"])
                if s == 2:
                    rev_sm = torch.where(qsm["is_inf"], pdf_w2, rev_sm)
                over[("l", s - 2)] = rev_sm
                # qs seen from pt (arriving from pt's predecessor)
                pdf_w3 = _v_pdf(pack, pt, pt["wi"], dc, present)
                over[("l", s - 1)] = _to_area(pdf_w3, pt["p"], qs["p"], qs["ns"],
                                              medium_to=qs["is_medium"])
                if t >= 3:
                    ptm = cam[t - 3]
                    pdf_w4 = _v_pdf(pack, pt, dc, pt["wi"], present)
                    over[("c", t - 3)] = _to_area(pdf_w4, pt["p"], ptm["p"], ptm["ns"],
                                                  medium_to=ptm["is_medium"])
                w_mis = _mis_weight(s, t, cam, light, over, false_arr)
                L = L + torch.where(ok[..., None], contrib * w_mis[..., None], 0.0)

        # ---- t = 1: light-image splats (s edges) ----
        for s in range(1, len(light) + 1):
            if s > max_edges:
                break
            if not _gate(s):
                continue
            qs = light[s - 1]
            v = cam_pos[None, :] - qs["p"]
            d2 = torch.clamp(mm.dot(v, v), min=1e-12)
            dist = torch.sqrt(d2)
            dc = v / dist[..., None]  # qs -> camera

            if s == 1:
                # the emitter radiates straight into the camera.  The
                # reference skips (1, 1) for delta-position emitters ("can't
                # connect degenerate endpoints", bdpt_proc.cpp:243-246), so
                # only area lights splat here
                if AREA in kinds or not kinds:
                    d_fac = torch.clamp(mm.dot(qs["ns"], dc), min=0.0)
                    d_fac = torch.where(qs["kind"] == AREA, d_fac, 0.0)
                else:
                    d_fac = torch.zeros(r, dtype=torch.float32, device=dev)
                val = qs["beta"] * d_fac[..., None]
                ok = qs["valid"] & (d_fac > 0)
            else:
                val = qs["beta"] * _v_f(pack, qs, dc, present)
                ok = qs["valid"]

            # project into the image
            sx, sy, inside = project(cam_info, qs["p"])
            ok = ok & inside & (val.amax(dim=-1) > 0)
            tr1 = conn_tr(qs, dc, dist, qs["valid"])
            ok = ok & (tr1.amax(dim=-1) > 0)

            # overrides: qs seen from the camera; qs - 1 seen from qs
            k_cam = camera_importance(cam_info, -dc)
            over = {("l", s - 1): _to_area(k_cam, cam_pos[None, :], qs["p"], qs["ns"],
                                           medium_to=qs["is_medium"])}
            if s >= 2:
                qsm = light[s - 2]
                pdf_w2 = _v_pdf(pack, qs, dc, qs["wi"], present)
                rev_sm = _to_area(pdf_w2, qs["p"], qsm["p"], qsm["ns"], medium_to=qsm["is_medium"])
                if s == 2:
                    rev_sm = torch.where(qsm["is_inf"], pdf_w2, rev_sm)
                over[("l", s - 2)] = rev_sm
            w_mis = _mis_weight(s, 1, cam, light, over, false_arr)

            splat = val * (k_cam / d2 * w_mis)[..., None] * tr1
            splat = torch.where(ok[..., None], splat, 0.0)
            splats.append((torch.stack([sx * w, sy * h], dim=-1), splat, ok))
        return L, splats

    chunk_fn.stats = {"rays": 0}
    return chunk_fn


# -----------------------------------------------------------------------------
# the renderer
# -----------------------------------------------------------------------------

def render_bdpt(scene, spp=None, seed=0, pack=None, device="cuda"):
    """Bidirectional render on `device` (reference bdpt.py:1233-1298);
    image units match the path tracer.  Returns numpy [H, W, 3]; the rays
    traced are left in render_bdpt.last_ray_count.  A scene outside the
    envelope (no emitter) renders with the path backend, as in the
    reference."""
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device)
    if pack is None:
        pack = pack_scene(scene, device)
    if not supports_bdpt(pack):
        from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord
        from mitsuba_tpu_torch.renderer import render

        print("[bdpt] WARNING: scene outside the bdpt v2 envelope (participating media) "
              "— rendering with the unidirectional path backend instead")
        saved = scene.integrator
        scene.integrator = IntegratorRecord(
            kind="path", max_depth=saved.max_depth, rr_depth=saved.rr_depth
        )
        try:
            return render(scene, spp=spp, seed=seed, device=device, pack=pack)
        finally:
            scene.integrator = saved
    for img, _, rays in iter_bdpt(scene, pack, spp, seed, device):
        pass
    render_bdpt.last_ray_count = rays
    return img().cpu().numpy()


def iter_bdpt(scene, pack, spp=None, seed=0, device="cuda"):
    """The chunks of a bdpt render, one at a time.  Lanes are (sample,
    pixel) pairs, MTS_BDPT_LANES (131,072) to a chunk, so spp_chunk =
    max(1, min(spp, lanes // pixels)) samples per pixel; the last chunk
    may run past spp, as in the reference.  After each chunk yields
    (image(): the image of the samples so far, [H, W, 3] on the device;
    the samples per pixel so far; the rays traced so far, an int64
    tensor)."""
    from mitsuba_tpu_torch.film.film import splat_add

    sen = scene.sensor.record
    w, h = sen.film.width, sen.film.height
    spp = spp or sen.sampler.sample_count
    n_px = w * h
    lane_budget = int(os.environ.get("MTS_BDPT_LANES", DEFAULT_LANES))
    spp_chunk = max(1, min(spp, lane_budget // n_px))
    chunk_fn = make_bdpt_chunk(pack, scene.integrator, sen, w, h, seed)

    px = torch.arange(n_px, dtype=torch.int64, device=device)
    lane = px[None, :].expand(spp_chunk, n_px).reshape(-1)
    s_i = torch.arange(spp_chunk, dtype=torch.int64, device=device)[:, None]
    film = torch.zeros(h, w, 3, dtype=torch.float32, device=device)
    light_film = torch.zeros(h, w, 3, dtype=torch.float32, device=device)
    done = 0
    for _ in range(math.ceil(spp / spp_chunk)):
        sidx = ((done + s_i) & 0xFFFFFFFF).expand(spp_chunk, n_px).reshape(-1)
        L, splats = chunk_fn(lane, sidx)
        for pos, val, ok in splats:
            light_film = splat_add(light_film, pos, val, sen.film.rfilter, valid=ok)
        film = film + L.reshape(spp_chunk, h, w, 3).sum(dim=0)
        done += spp_chunk
        yield ((lambda f=film, lf=light_film, n=done: f / n + lf / (n * n_px)), done,
               chunk_fn.stats["rays"])
