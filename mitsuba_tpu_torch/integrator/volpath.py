"""Volumetric wavefront path tracer (port of
mitsuba_tpu/integrator/volpath.py, reference
src/integrators/path/volpath.cpp:76-382).

Each iteration is one transport event of every lane: a medium
scattering event (distance sampling in the lane's medium,
volpath.cpp:104) or a surface event (the `path` logic).  A lane carries
its current medium id; crossing a transmissive surface with media
attached switches it, and `null` boundaries pass straight through
without counting as a scattering event (volpath.cpp:292-382).  NEE from
both kinds of vertex is attenuated by the transmittance along the
shadow ray, which passes through up to SHADOW_SEGMENTS null boundaries
(sampleAttenuatedEmitterDirect, reference scene.h:558).  hideEmitters
hides the emitters a lane sees before its first scattering event; as in
the reference, strictNormals and subsurface materials play no part here.

The decision uniforms are `rand4(lane, sidx, event * 8 + slot)` whatever
the scene's sampler, as in the reference; tracking and transmittance
draw their own streams.  The reference's `while any(active)` becomes a
host loop over the lanes still active (core/lanes.py; the reference runs
every lane, in fixed shapes for the TPU).
"""

from __future__ import annotations

import torch

from mitsuba_tpu_torch.accel.intersect import fill_interaction, intersect
from mitsuba_tpu_torch.bsdf.eval import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.bsdf.plugins import NULL_BSDF
from mitsuba_tpu_torch.core import lanes, rng
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.gather import take_rows
from mitsuba_tpu_torch.core.lanes import LiveLanes
from mitsuba_tpu_torch.emitter import eval as em
from mitsuba_tpu_torch.integrator import path as _path
from mitsuba_tpu_torch.medium import eval as med_eval
from mitsuba_tpu_torch.scene.texture_eval import (
    mip_footprint,
    shading_frame,
    shading_params,
)

SHADOW_EPS = 1e-3
MAX_EVENTS_FACTOR = 3  # events can exceed maxDepth (null crossings)
SHADOW_SEGMENTS = 3  # null boundaries a shadow ray may cross

# RNG decision slots per event (the reference's layout, volpath.py:40-46)
_SLOTS_PER_BOUNCE = 8
_SLOT_DIST = 0
_SLOT_NEE = 1
_SLOT_BSDF = 2
_SLOT_RR = 3
_SLOT_PHASE = 4


def _is_null(pack, mat):
    return take_rows(pack.mat_type, torch.clamp(mat, min=0)) == NULL_BSDF


def _attenuated_visibility(pack, p, d, dist, med, lane, sidx, slot, seed):
    """Visibility x transmittance along a shadow segment, passing through
    `null` boundaries and multiplying each medium's transmittance on the
    way (reference volpath.py:50-92).  Segment k's transmittance draws
    from slot * 8 + k.  A lane still marching after SHADOW_SEGMENTS
    crossings keeps the transmittance so far (the reference's choice).
    Returns (tr [R, 3], the null boundaries crossed: an int64 tensor)."""
    r = p.shape[0]
    tr = torch.ones(r, 3, dtype=torch.float32, device=p.device)
    o, remaining, cur_med = p, dist, med
    marching = torch.ones(r, dtype=torch.bool, device=p.device)
    crossings = torch.zeros((), dtype=torch.int64, device=p.device)
    for k in range(SHADOW_SEGMENTS):
        hit = intersect(pack, o, d, remaining * (1.0 - SHADOW_EPS))
        seg_len = torch.where(hit.valid, hit.t, remaining)
        seg_tr = med_eval.transmittance(pack, cur_med, o, d, seg_len, lane, sidx,
                                        slot * 8 + k, seed)
        tr = torch.where(marching[..., None], tr * seg_tr, tr)
        its = fill_interaction(pack, o, d, hit)
        is_null = _is_null(pack, its.mat)
        blocked = marching & hit.valid & ~is_null
        tr = torch.where(blocked[..., None], 0.0, tr)
        passing = marching & hit.valid & is_null
        crossings = crossings + passing.sum()
        entering = mm.dot(d, its.ng) < 0
        cur_med = torch.where(passing, torch.where(entering, its.med_in, its.med_ex), cur_med)
        o = torch.where(passing[..., None], its.p + d * 1e-4, o)
        remaining = torch.where(passing, remaining - seg_len, remaining)
        # lanes without a hit are resolved: their tr stands
        marching = passing & (remaining > 1e-5)
    return tr, crossings


def volpath_trace(pack, integ, o, d, lane, sample_idx, sampler, seed=0):
    """Trace a batch of camera rays through the scene's media (reference
    volpath.py:95-332).  Returns L [R, 3].  Left as attributes of
    volpath_trace: last_ray_count (closest-hit + shadow rays, as the
    reference counts them), last_medium_events and last_null_crossings
    (int64 tensors: medium scattering events, and null boundaries crossed
    by shadow rays), and `events`, the events run by every call so far.
    Without media this is path_trace."""
    if not pack.meta.get("has_media", False):
        out = _path.path_trace(pack, integ, o, d, lane, sample_idx, sampler, seed)
        volpath_trace.last_ray_count = _path.path_trace.last_ray_count
        return out
    _path._check_integrator(pack, integ)
    r = o.shape[0]
    dev = o.device
    present = pack.meta["present_types"]
    max_depth = integ.max_depth if integ.max_depth > 0 else _path.MAX_BOUNCES_CAP
    rr_depth = max(integ.rr_depth, 1)

    slots = torch.arange(_SLOT_PHASE + 1, device=dev)

    L = torch.zeros(r, 3, dtype=torch.float32, device=dev)
    thr = torch.ones(r, 3, dtype=torch.float32, device=dev)
    eta = torch.ones(r, dtype=torch.float32, device=dev)
    active = torch.ones(r, dtype=torch.bool, device=dev)
    prev_pdf = torch.ones(r, dtype=torch.float32, device=dev)
    prev_delta = torch.ones(r, dtype=torch.bool, device=dev)
    depth = torch.zeros(r, dtype=torch.int32, device=dev)  # per-lane scattering depth
    med = torch.full((r,), pack.meta["camera_medium"], dtype=torch.int32, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    n_medium = torch.zeros((), dtype=torch.int64, device=dev)
    n_crossed = torch.zeros((), dtype=torch.int64, device=dev)

    # the events run on the lanes still active; L_out gathers the radiance
    L_out, live = torch.zeros_like(L), LiveLanes(r, dev)
    for event in range(max_depth * MAX_EVENTS_FACTOR):
        if event % lanes.EXIT_CHECK_EVERY == 0:
            live.write((L_out,), (L,))
            sub = live.narrow(active, L, thr, eta, o, d, active, prev_pdf, prev_delta, depth,
                              med, lane, sample_idx)
            if sub is None:
                break
            L, thr, eta, o, d, active, prev_pdf, prev_delta, depth, med, lane, sample_idx = sub
        volpath_trace.events += 1
        # the event's decision uniforms [R, slot, 4], drawn in one call
        u = rng.rand4(lane[:, None], sample_idx[:, None], event * _SLOTS_PER_BOUNCE + slots,
                      seed)
        n_rays = n_rays + active.sum()
        hit = intersect(pack, o, d)
        its = fill_interaction(pack, o, d, hit)
        t_surf = torch.where(its.valid, its.t, 1e8)

        # medium distance sampling (volpath.cpp:104)
        ms = med_eval.sample_distance(pack, med, o, d, t_surf, u[:, _SLOT_DIST, :3],
                                      lane, sample_idx, event, seed)
        thr = thr * torch.where(active[..., None], ms.weight, 1.0)
        medium_evt = active & ms.is_medium
        surface_evt = active & ~ms.is_medium
        surf_ok = surface_evt & its.valid
        n_medium = n_medium + medium_evt.sum()

        # escaped rays and emitter hits: no medium event on the way
        L = _path.emitted(pack, d, its, surface_evt, thr, L, prev_pdf, prev_delta,
                          hide=(depth == 0) if integ.hide_emitters else None)

        # medium event: phase sampling
        p_med = o + d * ms.t[..., None]
        d_phase, ph_pdf, ph_w = med_eval.phase_sample(pack, med, d, u[:, _SLOT_PHASE, :2], p=p_med)

        # surface event
        frame = shading_frame(pack, its)
        wi_l = frame.to_local(its.wi_world)
        sp = shading_params(pack, its.mat, its.uv, mip_footprint(pack, its), its=its)

        # one emitter sample and one attenuated shadow ray serve both kinds
        # of event (a per-lane choice of origin and scattering function)
        if pack.meta["n_emitters"] > 0:
            m3 = medium_evt[..., None]
            nee_origin = torch.where(m3, p_med, _path._offset_ray(its.p, its.ng, its.wi_world))
            ds = em.sample_direct(pack, nee_origin, u[:, _SLOT_NEE, :3])
            ph = med_eval.phase_eval(pack, med, d, ds.d, p=p_med)
            wo_l = frame.to_local(ds.d)
            f = torch.where(m3, ph[..., None].expand(-1, 3),
                            bsdf_eval(sp, wi_l, wo_l, present))
            nee_origin = torch.where(m3, nee_origin, _path._offset_ray(its.p, its.ng, ds.d))
            med_sh = torch.where(
                medium_evt, med,
                torch.where(mm.dot(ds.d, its.ng) < 0, its.med_in, its.med_ex),
            )
            scatters = medium_evt | surf_ok
            n_rays = n_rays + scatters.sum()
            tr, crossed = _attenuated_visibility(pack, nee_origin, ds.d, ds.dist, med_sh, lane,
                                                 sample_idx, event, seed)
            n_crossed = n_crossed + crossed
            other_pdf = torch.where(medium_evt, med_eval.phase_pdf(pack, med, d, ds.d, p=p_med),
                                    bsdf_pdf(sp, wi_l, wo_l, present))
            other_pdf = torch.where(ds.delta, 0.0, other_pdf)
            w_nee = torch.where(ds.delta, 1.0, _path.mi_weight(ds.pdf, other_pdf))
            contributes = scatters & (depth + 2 <= max_depth)  # the maxDepth gate
            L = L + torch.where(contributes[..., None],
                                thr * ds.value * tr * f * w_nee[..., None], 0.0)

        bs = bsdf_sample(sp, wi_l, u[:, _SLOT_BSDF, :2], u[:, _SLOT_BSDF, 2], present)
        d_surf = frame.to_world(bs.wo)
        # a transmission (a null pass-through too) enters the interior if
        # the new direction opposes ng
        new_med_surf = torch.where(mm.dot(d_surf, its.ng) < 0, its.med_in, its.med_ex)

        # merge the two kinds of event
        thr = thr * torch.where(surf_ok[..., None], bs.weight, 1.0)
        thr = thr * torch.where(medium_evt, ph_w, 1.0)[..., None]
        eta = eta * torch.where(surf_ok, bs.eta, 1.0)
        m3 = medium_evt[..., None]
        d_new = torch.where(m3, d_phase, d_surf)
        o_new = torch.where(m3, p_med, _path._offset_ray(its.p, its.ng, d_surf))
        med_new = torch.where(medium_evt, med, torch.where(surf_ok, new_med_surf, med))
        # a null crossing adds no depth (volpath.cpp:292) and keeps the MIS
        # state of the last real sampling event
        null_cross = surf_ok & _is_null(pack, its.mat)
        new_pdf = torch.where(medium_evt, ph_pdf, torch.where(null_cross, prev_pdf, bs.pdf))
        new_delta = torch.where(medium_evt, False, torch.where(null_cross, prev_delta, bs.delta))
        depth = depth + (medium_evt | (surf_ok & ~null_cross)).to(torch.int32)
        thr_max = thr.amax(dim=-1)
        active = (medium_evt | surf_ok) & (thr_max > 0) & (depth < max_depth)
        thr, active = _path._roulette(thr, thr_max, eta, active, depth >= rr_depth,
                                      u[:, _SLOT_RR, 0])
        a3 = active[..., None]
        o = torch.where(a3, o_new, o)
        d = torch.where(a3, d_new, d)
        prev_pdf = torch.where(active, new_pdf, prev_pdf)
        prev_delta = torch.where(active, new_delta, prev_delta)
        med = torch.where(active, med_new, med)

    else:
        live.write((L_out,), (L,))
    volpath_trace.last_ray_count = n_rays
    volpath_trace.last_medium_events = n_medium
    volpath_trace.last_null_crossings = n_crossed
    return L_out


volpath_trace.events = 0
_path.TRACE_FNS["volpath"] = volpath_trace
