"""Wavefront MIS path tracers (port of mitsuba_tpu/integrator/path.py
`path_trace` and `path_trace_regen`, reference
src/integrators/path/path.cpp:119-300).

`path_trace` traces a batch of camera rays to completion (the batched
wavefront); in `path_trace_regen` lane i owns a pixel and, when its path
terminates, starts the pixel's next sample at once.  Both run the same
bounce (`_bounce`): closest hit, environment radiance on escape and
emitter hit (both with MIS; none at depth 0 under hideEmitters), the
exitant radiance of subsurface materials (integrator/sss.py), next-event
estimation with a shadow ray, BSDF sampling; then Russian roulette,
which reads the relative IOR a refraction crossed (`eta`) as the
reference does.  strictNormals ends a path where the geometric and the
shading normal disagree about a direction's side.  A Dirac lobe (smooth
conductor, dielectric, plastic) carries MIS weight 1 to the emitter it
hits next, and a `null` crossing carries the previous MIS state.  The
reference's `lax.while_loop`s become host loops that check their exit
condition every EXIT_CHECK_EVERY iterations (core/lanes.py); iterations
in which no lane has work change nothing.

Also the one-bounce integrators of the same machinery: `direct_trace`,
`ao_trace` (ambient occlusion) and `field_trace` (AOVs; `depth` is the
`distance` field).
"""

from __future__ import annotations

import dataclasses

import torch

from mitsuba_tpu_torch.accel.intersect import fill_interaction, intersect, occluded
from mitsuba_tpu_torch.bsdf.eval import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.bsdf.plugins import NULL_BSDF
from mitsuba_tpu_torch.core import lanes, rng, warp
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.gather import take_rows
from mitsuba_tpu_torch.emitter import eval as em
from mitsuba_tpu_torch.integrator.sss import subsurface_radiance
from mitsuba_tpu_torch.sampler.plugins import ld_decision4
from mitsuba_tpu_torch.scene.texture_eval import (
    mip_footprint,
    shading_frame,
    shading_params,
)

SHADOW_EPS = 1e-3
MAX_BOUNCES_CAP = 64  # hard cap when maxDepth = -1 (infinite)

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
    # volpath on a scene without media is the path integrator (reference
    # integrator/volpath.py:95-99, renderer.py:78-92); direct is the path
    # integrator cut to one bounce (direct_trace)
    if integ.kind not in ("path", "volpath", "direct"):
        raise NotImplementedError(f"integrator '{integ.kind}' not yet ported")


def emitted(pack, d, its, reach, thr, L, prev_pdf, prev_delta, hide=None):
    """L plus what the lanes of `reach` (those whose ray ends at the
    surface `its` or escapes) see along d: the environment's radiance
    where the ray escapes, an area emitter's where it hits one, each with
    MIS against the previous sampling event (reference path.cpp:148-150
    and :255-263).  hide (None, a bool or [R] bool): lanes whose emitters
    are hidden, weight 0 (hideEmitters at depth 0, reference
    path.py:131, :145)."""
    hide = None if hide is None else torch.as_tensor(hide, device=d.device)
    if pack.meta.get("has_env", False):
        escape = reach & ~its.valid
        env_l = em.eval_env(pack, d)
        w_env = torch.where(
            prev_delta, 1.0, mi_weight(prev_pdf, em.pdf_direct_env(pack, d))
        )
        if hide is not None:
            w_env = torch.where(hide, 0.0, w_env)
        L = L + torch.where(escape[..., None], thr * env_l * w_env[..., None], 0.0)
    if pack.meta["has_area"]:
        cos_l = mm.dot(its.ns, its.wi_world)
        emissive = reach & its.valid & (its.emit >= 0) & (cos_l > 0)
        le = take_rows(pack.em_rgb, torch.clamp(its.emit, min=0))
        p_direct = em.pdf_direct_area(pack, its.emit, its.t, cos_l)
        w_hit = torch.where(prev_delta, 1.0, mi_weight(prev_pdf, p_direct))
        if hide is not None:
            w_hit = torch.where(hide, 0.0, w_hit)
        L = L + torch.where(emissive[..., None], thr * le * w_hit[..., None], 0.0)
    return L


def _bounce(pack, integ, o, d, active, thr, eta, L, prev_pdf, prev_delta, depth, max_depth,
            u4, keys, nee_nonzero=False):
    """One bounce of every lane, as both of the reference's loops run it:
    closest hit, escaped rays and emitter hits with MIS, the subsurface
    exitant radiance, NEE with a shadow ray, BSDF sampling (the callers
    drop lanes whose throughput is 0), with the integrator's
    hideEmitters and strictNormals.  depth: int or [R] int32;
    u4(depth, slot) -> [R, 4] decision uniforms; keys: (lane, sample
    index, seed) of the single-scattering draws.  nee_nonzero adds
    path_trace's gate on a nonzero emitter value and BSDF value to the NEE
    contribution.
    Returns (L, active, thr, eta, o_bounce, d_bounce, new_pdf, new_delta,
    u_rr, n_rays): the state after the BSDF sample, the previous MIS state
    carried through null crossings, the NEE draw's 4th uniform (the RR
    draw; None without emitters) and the rays traced."""
    present = pack.meta["present_types"]
    n_rays = active.sum()
    hit = intersect(pack, o, d)
    its = fill_interaction(pack, o, d, hit)
    L = emitted(pack, d, its, active, thr, L, prev_pdf, prev_delta,
                hide=(depth == 0) if integ.hide_emitters else None)
    active = its.valid & active

    # subsurface exitant radiance at every surface hit (reference
    # path.cpp:153-154, its.LoSub)
    if pack.meta.get("has_sss", False):
        # the incident directions: d (the reference's regenerating loop
        # passes -wi, which is d, bit for bit)
        lane, sidx, seed = keys
        L = subsurface_radiance(pack, its, active, thr, L, d, lane, sidx, depth, seed)

    frame = shading_frame(pack, its)
    wi_l = frame.to_local(its.wi_world)
    sp = shading_params(pack, its.mat, its.uv, mip_footprint(pack, its), its=its)
    # strict normals: geometric and shading normal must agree about wi's
    # side (reference path.cpp:165-172)
    if integ.strict_normals:
        active = active & (mm.dot(its.wi_world, its.ng) * mm.cos_theta(wi_l) > 0)

    # next-event estimation (reference path.cpp:176-198, scene.cpp:828-841)
    u_rr = None  # the 4th NEE component doubles as the RR draw
    if pack.meta["n_emitters"] > 0:
        n_rays = n_rays + active.sum()
        u_n = u4(depth, _SLOT_NEE)
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
        # NEE makes a (depth + 2)-edge path: the reference's maxDepth
        # gate (path.cpp:157)
        contributes = active & ~occ & (depth + 2 <= max_depth)
        if nee_nonzero:
            contributes = contributes & (ds.value.amax(dim=-1) > 0) & (f.amax(dim=-1) > 0)
        L = L + torch.where(
            contributes[..., None], thr * ds.value * f * w_nee[..., None], 0.0
        )

    # BSDF sampling (reference path.cpp:209-253)
    u_b = u4(depth, _SLOT_BSDF)
    bs = bsdf_sample(sp, wi_l, u_b[..., :2], u_b[..., 2], present)
    thr = thr * torch.where(active[..., None], bs.weight, 1.0)
    eta = eta * torch.where(active, bs.eta, 1.0)
    d_bounce = frame.to_world(bs.wo)
    if integ.strict_normals:
        active = active & (mm.dot(d_bounce, its.ng) * mm.cos_theta(bs.wo) > 0)
    o_bounce = _offset_ray(its.p, its.ng, d_bounce)
    # a null (index-matched) crossing is not a scattering event
    is_null = sp["type"] == NULL_BSDF
    new_pdf = torch.where(is_null, prev_pdf, bs.pdf)
    new_delta = torch.where(is_null, prev_delta, bs.delta)
    return L, active, thr, eta, o_bounce, d_bounce, new_pdf, new_delta, u_rr, n_rays


def _roulette(thr, thr_max, eta, active, do_rr, u_r):
    """Russian roulette (reference path.cpp:276-285): survival q =
    min(thr_max * eta^2, 0.95), thr_max = max(thr), where do_rr (bool or
    [R] bool).  Returns (thr, active)."""
    do_rr = torch.as_tensor(do_rr, device=thr.device)
    q = torch.clamp(thr_max * eta * eta, max=0.95)
    keep = torch.where(do_rr, u_r < q, True)
    thr = torch.where(
        (do_rr & keep)[..., None], thr / torch.clamp(q, min=1e-6)[..., None], thr
    )
    return thr, active & keep


def path_trace(pack, integ, o, d, lane, sample_idx, sampler, seed=0):
    """Trace a batch of camera rays to completion (reference
    path.py:75-265).  o, d: [R, 3]; lane, sample_idx: [R] int64 RNG keys.
    Returns L [R, 3]; the rays traced (closest-hit + shadow, an int64
    tensor) are left in path_trace.last_ray_count."""
    _check_integrator(pack, integ)
    r = o.shape[0]
    device = o.device
    max_depth = integ.max_depth if integ.max_depth > 0 else MAX_BOUNCES_CAP
    rr_depth = max(integ.rr_depth, 1)

    def u4(depth, slot):
        dslot = depth * _SLOTS_PER_BOUNCE + slot
        base = rng.rand4(lane, sample_idx, dslot, seed)
        return ld_decision4(sampler, lane, sample_idx, dslot, base, seed)

    L = torch.zeros(r, 3, dtype=torch.float32, device=device)
    thr = torch.ones(r, 3, dtype=torch.float32, device=device)
    eta = torch.ones(r, dtype=torch.float32, device=device)
    active = torch.ones(r, dtype=torch.bool, device=device)
    prev_pdf = torch.ones(r, dtype=torch.float32, device=device)
    prev_delta = torch.ones(r, dtype=torch.bool, device=device)  # depth-0 hits count fully
    n_rays = torch.zeros((), dtype=torch.int64, device=device)
    for depth in range(max_depth):
        if depth % lanes.EXIT_CHECK_EVERY == 0 and not bool(active.any()):
            break
        L, active, thr, eta, o_b, d_b, new_pdf, new_delta, u_rr, n = _bounce(
            pack, integ, o, d, active, thr, eta, L, prev_pdf, prev_delta, depth, max_depth, u4,
            (lane, sample_idx, seed), nee_nonzero=True,
        )
        n_rays = n_rays + n
        thr_max = thr.amax(dim=-1)
        active = active & (thr_max > 0)
        u_r = u_rr if u_rr is not None else u4(depth, _SLOT_RR)[..., 0]
        thr, active = _roulette(thr, thr_max, eta, active, depth + 1 >= rr_depth, u_r)
        a3 = active[..., None]
        o = torch.where(a3, o_b, o)
        d = torch.where(a3, d_b, d)
        prev_pdf = torch.where(active, new_pdf, prev_pdf)
        prev_delta = torch.where(active, new_delta, prev_delta)
    path_trace.last_ray_count = n_rays
    return L


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

    for it in range(max_iters):
        if it % lanes.EXIT_CHECK_EVERY == 0 and not bool(
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

        def u4(depth, slot, sidx=sidx):
            dslot = depth * _SLOTS_PER_BOUNCE + slot
            base = rng.rand4(lane, sidx, dslot, seed)
            return ld_decision4(sampler, lane, sidx, dslot, base, seed)

        # ---- one bounce ----
        L, active, thr, eta, o_bounce, d_bounce, new_pdf, new_delta, u_rr, n = _bounce(
            pack, integ, o, d, active, thr, eta, L, prev_pdf, prev_delta, depth, max_depth, u4,
            (lane, sidx, seed),
        )
        n_rays = n_rays + n
        thr_max = thr.amax(dim=-1)
        active = active & (thr_max > 0)
        depth = depth + 1
        active = active & (depth < max_depth)
        u_r = u_rr if u_rr is not None else u4(depth, _SLOT_RR)[..., 0]
        thr, active = _roulette(thr, thr_max, eta, active, depth >= rr_depth, u_r)
        a3 = active[..., None]
        o = torch.where(a3, o_bounce, o)
        d = torch.where(a3, d_bounce, d)
        prev_pdf = torch.where(active, new_pdf, prev_pdf)
        prev_delta = torch.where(active, new_delta, prev_delta)

    return L_acc + L, sample_i, n_rays


def direct_trace(pack, integ, o, d, lane, sample_idx, sampler, seed=0):
    """MIDirect: emitter and BSDF sampling of direct illumination only
    (reference path.py:568-572, src/integrators/direct/direct.cpp): the
    path tracer at maxDepth 2 without roulette.  The chain integrators
    render their direct component through it (pssmlt.add_direct_component).
    The rays traced are left in direct_trace.last_ray_count."""
    one_bounce = dataclasses.replace(integ, max_depth=2, rr_depth=100)
    L = path_trace(pack, one_bounce, o, d, lane, sample_idx, sampler, seed)
    direct_trace.last_ray_count = path_trace.last_ray_count
    return L


def ao_trace(pack, integ, o, d, lane, sample_idx, sampler, seed=0):
    """Ambient occlusion (reference path.py:575-595, src/integrators/
    direct/ao.cpp): 1 where a cosine-distributed ray from the first hit
    meets nothing within rayLength (1e7 when not positive), else 0.  The
    rays traced (a closest hit and an occlusion ray a lane) are left in
    ao_trace.last_ray_count."""
    r = o.shape[0]
    hit = intersect(pack, o, d)
    its = fill_interaction(pack, o, d, hit)
    frame = shading_frame(pack, its)
    u = rng.rand4(lane, sample_idx, 1, seed)
    wo = frame.to_world(warp.square_to_cosine_hemisphere(u[..., :2]))
    length = integ.ray_length if integ.ray_length > 0 else 1e7
    occ = occluded(pack, _offset_ray(its.p, its.ng, wo), wo,
                   torch.full((r,), length, dtype=torch.float32, device=o.device))
    vis = torch.where(its.valid & ~occ, 1.0, 0.0)
    ao_trace.last_ray_count = torch.tensor(2 * r, dtype=torch.int64, device=o.device)
    return vis[..., None].expand(r, 3).clone()


def field_trace(pack, integ, o, d, lane, sample_idx, sampler, seed=0):
    """AOV extraction at the first hit (reference path.py:597-626,
    src/integrators/misc/field.cpp): position, relPosition, distance,
    geoNormal, shNormal / normal, uv, albedo, primIndex or emission; 0
    where the ray escapes.  The rays traced (one a lane) are left in
    field_trace.last_ray_count."""
    hit = intersect(pack, o, d)
    its = fill_interaction(pack, o, d, hit)
    name = integ.field_name
    if name == "position":
        v = its.p
    elif name == "relPosition":
        v = its.p - o
    elif name == "distance":
        v = its.t[..., None].expand(-1, 3)
    elif name == "geoNormal":
        v = its.ng
    elif name in ("shNormal", "normal"):
        v = its.ns
    elif name == "uv":
        v = torch.cat([its.uv, torch.zeros_like(its.uv[..., :1])], dim=-1)
    elif name == "albedo":
        v = shading_params(pack, its.mat, its.uv, mip_footprint(pack, its), its=its)["cA"]
    elif name == "primIndex":
        v = its.prim[..., None].to(torch.float32).expand(-1, 3)
    elif name == "emission":
        le = take_rows(pack.em_rgb, torch.clamp(its.emit, min=0))
        v = torch.where((its.emit >= 0)[..., None], le, 0.0)
    else:
        raise ValueError(f"field: unknown field '{name}'")
    field_trace.last_ray_count = torch.tensor(o.shape[0], dtype=torch.int64, device=o.device)
    return torch.where(its.valid[..., None], v, 0.0)


# trace functions of the batched wavefront by integrator kind
# (integrator/volpath.py adds "volpath")
TRACE_FNS = {"path": path_trace, "direct": direct_trace, "ao": ao_trace, "field": field_trace}
