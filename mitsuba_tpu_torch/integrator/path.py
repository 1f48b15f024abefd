"""Regenerating wavefront MIS path tracer (port of
mitsuba_tpu/integrator/path.py `path_trace_regen`, reference
src/integrators/path/path.cpp:119-300).

Lane i owns a pixel; when its path terminates it starts the pixel's next
sample at once.  One bounce per iteration: closest hit, emitter hit with
MIS, next-event estimation with a shadow ray, diffuse BSDF sampling and
Russian roulette.  The reference's `lax.while_loop` becomes a host loop
that checks its exit condition every EXIT_CHECK_EVERY iterations;
iterations in which no lane has work change nothing.
"""

from __future__ import annotations

import torch

from mitsuba_tpu_torch.accel.intersect import fill_interaction, intersect, occluded
from mitsuba_tpu_torch.bsdf.eval import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.bsdf.plugins import NULL_BSDF
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.core.gather import take_rows
from mitsuba_tpu_torch.emitter import eval as em
from mitsuba_tpu_torch.sampler.plugins import ld_decision4
from mitsuba_tpu_torch.scene.texture_eval import (
    mip_footprint,
    shading_frame,
    shading_params,
)

SHADOW_EPS = 1e-3
MAX_BOUNCES_CAP = 64  # hard cap when maxDepth = -1 (infinite)
EXIT_CHECK_EVERY = 8

# RNG decision slots per bounce (the reference's layout, path.py:37-41)
_SLOTS_PER_BOUNCE = 4
_SLOT_NEE = 1
_SLOT_BSDF = 2
_SLOT_RR = 3


def mi_weight(pdf_a, pdf_b):
    """Power heuristic, beta = 2 (reference path.cpp:296-300)."""
    pdf_a = pdf_a * pdf_a
    pdf_b = pdf_b * pdf_b
    return torch.where(
        pdf_a + pdf_b > 0, pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-30), 0.0
    )


def _offset_ray(p, n, d):
    """Offset a spawn point along the geometric normal against
    self-intersection."""
    s = mm.sign(mm.dot(n, d))[..., None]
    return p + n * s * 1e-4


def _check_integrator(pack, integ):
    if integ.kind != "path":
        raise NotImplementedError(f"integrator '{integ.kind}' not yet ported")
    if integ.strict_normals or integ.hide_emitters:
        raise NotImplementedError("path options strictNormals/hideEmitters not yet ported")
    if pack.meta.get("has_env", False) or pack.meta.get("has_sss", False):
        raise NotImplementedError("environment lights / subsurface not yet ported")


def path_trace_regen(
    pack, integ, make_ray, n_lanes, spp, lane, sampler, seed=0,
    sidx_offset=0,
):
    """Persistent-wavefront path tracing with same-pixel regeneration.

    make_ray(sample_i) -> (o, d) [n_lanes, 3] camera rays for every lane
    at its per-lane sample number; lane: [n_lanes] int64 pixel ids (RNG
    keys); sidx_offset: int or [n_lanes] int64 sample-index offsets.
    Returns (L_sum [n,3], n_samples_done [n] int32, n_rays int64 tensor:
    closest-hit + shadow rays traced).
    """
    _check_integrator(pack, integ)
    device = lane.device
    r = n_lanes
    present = pack.meta["present_types"]
    max_depth = integ.max_depth if integ.max_depth > 0 else MAX_BOUNCES_CAP
    rr_depth = max(integ.rr_depth, 1)
    # generous upper bound; the exit check ends the loop long before
    max_iters = spp * max_depth + max_depth + 4
    sidx_off = torch.as_tensor(sidx_offset, dtype=torch.int64, device=device)
    sidx_off = sidx_off.expand(r)

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    L_acc, L = f32(r, 3), f32(r, 3)
    thr = torch.ones(r, 3, dtype=torch.float32, device=device)
    eta = torch.ones(r, dtype=torch.float32, device=device)
    o, d = f32(r, 3), f32(r, 3)
    active = torch.zeros(r, dtype=torch.bool, device=device)
    prev_pdf = torch.ones(r, dtype=torch.float32, device=device)
    prev_delta = torch.ones(r, dtype=torch.bool, device=device)
    depth = torch.zeros(r, dtype=torch.int32, device=device)
    sample_i = torch.zeros(r, dtype=torch.int32, device=device)  # started
    n_rays = torch.zeros((), dtype=torch.int64, device=device)

    def u4(sample_idx, depth, slot):
        dslot = depth * _SLOTS_PER_BOUNCE + slot
        base = rng.rand4(lane, sample_idx, dslot, seed)
        return ld_decision4(sampler, lane, sample_idx, dslot, base, seed)

    for it in range(max_iters):
        if it % EXIT_CHECK_EVERY == 0 and not bool(
            (active | (sample_i < spp)).any()
        ):
            break
        # ---- regeneration: finished lanes start their next sample ----
        regen = ~active & (sample_i < spp)
        rg3 = regen[..., None]
        L_acc = L_acc + torch.where(rg3, L, 0.0)
        L = torch.where(rg3, 0.0, L)
        o_new, d_new = make_ray(sample_i)
        o = torch.where(rg3, o_new, o)
        d = torch.where(rg3, d_new, d)
        thr = torch.where(rg3, 1.0, thr)
        eta = torch.where(regen, 1.0, eta)
        depth = torch.where(regen, 0, depth)
        prev_pdf = torch.where(regen, 1.0, prev_pdf)
        prev_delta = prev_delta | regen
        sample_i = sample_i + regen.to(torch.int32)
        active = active | regen
        # global sample index: includes the pass / layer offset
        sidx = sidx_off + torch.clamp(sample_i - 1, min=0).to(torch.int64)

        n_rays = n_rays + active.sum()

        # ---- one bounce ----
        hit = intersect(pack, o, d)
        its = fill_interaction(pack, o, d, hit)
        found = its.valid & active

        if pack.meta["has_area"]:
            cos_l = mm.dot(its.ns, its.wi_world)
            emissive = found & (its.emit >= 0) & (cos_l > 0)
            le = take_rows(pack.em_rgb, torch.clamp(its.emit, min=0))
            p_direct = em.pdf_direct_area(pack, its.emit, its.t, cos_l)
            w_hit = torch.where(prev_delta, 1.0, mi_weight(prev_pdf, p_direct))
            L = L + torch.where(emissive[..., None], thr * le * w_hit[..., None], 0.0)

        active = found

        frame = shading_frame(pack, its)
        wi_l = frame.to_local(its.wi_world)
        sp = shading_params(pack, its.mat, its.uv, mip_footprint(pack, its), its=its)

        u_rr = None  # the 4th NEE component doubles as the RR draw
        if pack.meta["n_emitters"] > 0:
            n_rays = n_rays + active.sum()
            u_n = u4(sidx, depth, _SLOT_NEE)
            u_rr = u_n[..., 3]
            ds = em.sample_direct(pack, its.p, u_n[..., :3])
            wo_l = frame.to_local(ds.d)
            f = bsdf_eval(sp, wi_l, wo_l, present)
            o_sh = _offset_ray(its.p, its.ng, ds.d)
            shadow_t = torch.where(
                ds.dist >= em.ENV_DIST, 1e7, ds.dist * (1.0 - SHADOW_EPS)
            )
            occ = occluded(pack, o_sh, ds.d, shadow_t)
            b_pdf = torch.where(ds.delta, 0.0, bsdf_pdf(sp, wi_l, wo_l, present))
            w_nee = torch.where(ds.delta, 1.0, mi_weight(ds.pdf, b_pdf))
            # reference maxDepth gate (path.cpp:157)
            contributes = active & ~occ & (depth + 2 <= max_depth)
            L = L + torch.where(
                contributes[..., None], thr * ds.value * f * w_nee[..., None], 0.0
            )

        u_b = u4(sidx, depth, _SLOT_BSDF)
        bs = bsdf_sample(sp, wi_l, u_b[..., :2], u_b[..., 2], present)
        thr = thr * torch.where(active[..., None], bs.weight, 1.0)
        eta = eta * torch.where(active, bs.eta, 1.0)
        d_bounce = frame.to_world(bs.wo)
        o_bounce = _offset_ray(its.p, its.ng, d_bounce)
        thr_max = thr.amax(dim=-1)
        active = active & (thr_max > 0)

        depth = depth + 1
        active = active & (depth < max_depth)

        u_r = u_rr if u_rr is not None else u4(sidx, depth, _SLOT_RR)[..., 0]
        q = torch.clamp(thr_max * eta * eta, max=0.95)
        do_rr = depth >= rr_depth
        keep = torch.where(do_rr, u_r < q, True)
        thr = torch.where(
            (do_rr & keep)[..., None], thr / torch.clamp(q, min=1e-6)[..., None], thr
        )
        active = active & keep

        # a null (index-matched) crossing is not a scattering event
        is_null = sp["type"] == NULL_BSDF
        new_pdf = torch.where(is_null, prev_pdf, bs.pdf)
        new_delta = torch.where(is_null, prev_delta, bs.delta)
        a3 = active[..., None]
        o = torch.where(a3, o_bounce, o)
        d = torch.where(a3, d_bounce, d)
        prev_pdf = torch.where(active, new_pdf, prev_pdf)
        prev_delta = torch.where(active, new_delta, prev_delta)

    return L_acc + L, sample_i, n_rays
