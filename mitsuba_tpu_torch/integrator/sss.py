"""Subsurface scattering at render time: the irradiance pass, the dipole
query and fast single scattering (port of mitsuba_tpu/integrator/sss.py,
reference src/subsurface/dipole.cpp, src/librender/irrproc.cpp and
src/subsurface/singlescatter.cpp).

* `compute_sss_irradiance` / `prepare_sss`: the preprocess.  E at every
  packed surface point from irrSamples rays a point: one emitter sample
  with a shadow ray (the direct term), plus, with irrIndirect, a
  cosine-distributed ray handed to the path tracer with its depth-0
  emitters hidden (E_ind = pi * mean(Li)).  `prepare_sss` returns a new
  pack whose sss_E holds E; the caller's pack keeps its zeros, so every
  render of one pack starts from the same E.
* `sss_lo`: Lo(xo, wo) = Ft(eta, cos_o) / pi * sum_i dMo(|xo - xi|) E_i
  A_i with the isotropic dipole kernel dMo = 1/(4 pi) [C1 e^{-s d_r} /
  d_r^2 + C2 e^{-s d_v} / d_v^2] (dipole.cpp IsotropicDipoleQuery:40-58,
  Lo:336-349), a dense masked sum over the point set in CHUNK-point
  steps instead of the reference's octree.
* `single_scatter_lo`: the refracted view ray, exponential distance
  samples along it, straight connections to an emitter through the exit
  point with boundary Fresnel and Beer-Lambert attenuation, and the
  internal-reflection bounces up to singleScatterDepth.

A lane's value depends only on its own inputs, so both queries run on
the lanes that need them (the callers' subsurface lanes) and leave the
others zero; each gathers its object's row at max(sid, 0), as the
reference does, so that no lane indexes with -1.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mitsuba_tpu_torch.accel.intersect import fill_interaction, intersect, occluded
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import rng, warp
from mitsuba_tpu_torch.core.gather import take_fused
from mitsuba_tpu_torch.emitter import eval as em

INV_PI = 1.0 / math.pi
INV_FOURPI = 0.25 / math.pi
# points per step of the dense dipole sum: the reference's step, so that
# the float sums run in its order (a sum over each step's points, the
# steps added in turn)
CHUNK = 128
# lanes per block of the dense sum: a step's [lanes, CHUNK, 3] float32
# temporaries stay at ~100 MB each
LANE_BLOCK = 1 << 16


def compute_sss_irradiance(pack, integ, seed=0):
    """E [P, 3] at every packed subsurface point (reference sss.py:34-87):
    the mean over sss_irr_samples rays a point of the direct term and,
    with sss_indirect, pi times the radiance of a cosine-distributed ray
    traced by path_trace at maxDepth 4 with hidden depth-0 emitters."""
    from mitsuba_tpu_torch.integrator.path import path_trace

    pts, nrm = pack.sss_p, pack.sss_n
    dev = pts.device
    p_cnt = pts.shape[0]
    k = int(pack.meta.get("sss_irr_samples", 16))
    sseed = rng.stream_seed(seed, rng.STREAM_SSS)

    lane = torch.arange(p_cnt, dtype=torch.int64, device=dev).repeat_interleave(k)
    sidx = torch.arange(k, dtype=torch.int64, device=dev).repeat(p_cnt)
    p_l = pts.repeat_interleave(k, dim=0)
    n_l = nrm.repeat_interleave(k, dim=0)

    e_total = torch.zeros(p_cnt * k, 3, dtype=torch.float32, device=dev)
    if pack.meta["n_emitters"] > 0:
        u3 = rng.rand4(lane, sidx, 0, sseed)[..., :3]
        ds = em.sample_direct(pack, p_l, u3)
        cos_i = mm.dot(n_l, ds.d)
        o_sh = p_l + n_l * 1e-4
        shadow_t = torch.where(ds.dist >= em.ENV_DIST, 1e7, ds.dist * (1.0 - 1e-3))
        occ = occluded(pack, o_sh, ds.d, shadow_t)
        e_total = torch.where(((cos_i > 0) & ~occ)[..., None],
                              ds.value * torch.clamp(cos_i, min=0.0)[..., None], 0.0)

    if pack.meta.get("sss_indirect", True):
        # the depth-0 emitters are the direct term above (irrproc.cpp:73-90);
        # the trace is the path tracer's whatever the scene's integrator
        u2 = rng.rand4(lane, sidx, 1, sseed)[..., :2]
        d = mm.Frame.from_normal(n_l).to_world(warp.square_to_cosine_hemisphere(u2))
        o = p_l + n_l * 1e-4
        integ_ind = dataclasses.replace(integ, kind="path", hide_emitters=True, max_depth=4)
        li = path_trace(pack, integ_ind, o, d, lane, sidx, None, seed=sseed ^ 0x1D)
        e_total = e_total + math.pi * li

    return e_total.reshape(p_cnt, k, 3).mean(dim=1)


def prepare_sss(pack, integ, seed=0):
    """The preprocess: a new pack whose sss_E holds the irradiance pass's
    E (reference sss.py:90-96); `pack` is not changed."""
    e_pts = compute_sss_irradiance(pack, integ, seed)
    return type(pack)({**pack.arrays, "sss_E": e_pts}, dict(pack.meta))


def _dipole_sum(pack, p, s, zr, zv, s_tr):
    """Mo [R, 3] = sum_i dMo(|p - x_i|) E_i A_i over the points of object
    s [R] (>= 0), CHUNK points a step."""
    r = p.shape[0]
    mo = torch.zeros(r, 3, dtype=torch.float32, device=p.device)
    p_cnt = pack.sss_p.shape[0]
    zr2, zv2 = (zr * zr)[:, None, :], (zv * zv)[:, None, :]
    zr_, zv_, st = zr[:, None, :], zv[:, None, :], s_tr[:, None, :]
    for c0 in range(0, p_cnt, CHUNK):
        cp = pack.sss_p[c0:c0 + CHUNK]
        ce = pack.sss_E[c0:c0 + CHUNK]
        ca = pack.sss_area[c0:c0 + CHUNK]
        co = pack.sss_obj[c0:c0 + CHUNK]
        d2 = ((p[:, None, :] - cp[None, :, :]) ** 2).sum(dim=-1)
        wgt = ca[None, :] * (co[None, :] == s[:, None]).to(torch.float32)  # [R, C]
        d2e = d2[..., None]
        dr = torch.sqrt(d2e + zr2)
        dv = torch.sqrt(d2e + zv2)
        c1 = zr_ * (st + 1.0 / dr)
        c2 = zv_ * (st + 1.0 / dv)
        dmo = INV_FOURPI * (c1 * torch.exp(-st * dr) / (dr * dr)
                            + c2 * torch.exp(-st * dv) / (dv * dv))
        mo = mo + (dmo * ce[None, :, :] * wgt[..., None]).sum(dim=1)
    return mo


def sss_lo(pack, p, cos_o, sid):
    """Exitant subsurface radiance [R, 3] at p [R, 3] with outgoing cosine
    cos_o [R], for lanes of dipole object sid [R] (reference
    sss.py:99-152; callers mask the lanes with sid < 0)."""
    s = torch.clamp(sid, min=0)
    zr, zv, s_tr, eta = take_fused(s, pack.sss_zr, pack.sss_zv, pack.sss_str, pack.sss_eta)
    mo = torch.cat([
        _dipole_sum(pack, p[b:b + LANE_BLOCK], s[b:b + LANE_BLOCK], zr[b:b + LANE_BLOCK],
                    zv[b:b + LANE_BLOCK], s_tr[b:b + LANE_BLOCK])
        for b in range(0, p.shape[0], LANE_BLOCK)
    ] or [torch.zeros(0, 3, dtype=torch.float32, device=p.device)])
    # boundary transmittance (dipole.cpp:Lo; none at eta == 1)
    fr, _, _ = mm.fresnel_dielectric(torch.clamp(cos_o, min=0.0), eta)
    ft = torch.where(torch.abs(eta - 1.0) < 1e-5, 1.0, 1.0 - fr)
    return mo * (INV_PI * ft)[..., None]


def single_scatter_lo(pack, p, d_in, ng, sid, lane, sidx, depth, seed):
    """Single scattering along the refracted view ray (reference
    sss.py:155-284, singlescatter.cpp LoSingle:1326-1480, the
    fastSingleScatter branch), with the internal reflections unrolled as
    sss_ss_depth segments: at each far boundary the ray reflects with the
    inside Fresnel weight, and the segment's Beer-Lambert factor
    multiplies the carried throughput.

    p: surface hits [R, 3]; d_in: the incident direction (toward the
    surface) [R, 3]; ng: outward geometric normals [R, 3]; sid: subsurface
    object per lane (< 0: none, returns 0); lane, sidx: RNG keys [R];
    depth: the path depth, an int or [R] (the draw slots are 64 + ((depth
    * 8 + bounce) * samples + k) * 2 and one past it)."""
    r = p.shape[0]
    s = torch.clamp(sid, min=0)
    sigs, sigt, g, eta = take_fused(s, pack.sss_sigs, pack.sss_sigt, pack.sss_g, pack.sss_eta)
    ns = int(pack.meta.get("sss_ss_samples", 2))
    n_bounce = int(pack.meta.get("sss_ss_depth", 4))
    sseed = rng.stream_seed(seed, rng.STREAM_SSS)

    # refract the view ray into the medium (+z = the outward normal)
    frame = mm.Frame.from_normal(ng)
    wi_l = frame.to_local(-d_in)
    cos_i = mm.cos_theta(wi_l)
    fr_in, _, _ = mm.fresnel_dielectric(torch.abs(cos_i), eta)
    wt_l, tir, _ = mm.refract_local(wi_l, eta)
    d_int = frame.to_world(wt_l)  # into the object
    alive = (sid >= 0) & (cos_i > 0) & ~tir

    # exponential sampling radius: the mean free path
    radius = 1.0 / torch.clamp(sigt.mean(dim=-1), min=1e-6)

    lo = torch.zeros(r, 3, dtype=torch.float32, device=p.device)
    o_seg = p + d_int * 1e-4  # the segment's origin
    d_seg = d_int
    # throughput into the segment: the entry transmittance times the
    # reflection Fresnels and segment attenuations of the bounces before
    thr = (1.0 - fr_in)[..., None].expand(r, 3)

    for b in range(n_bounce):
        # the span to the segment's far boundary
        hit2 = intersect(pack, o_seg, d_seg)
        thickness = torch.where(hit2.valid, hit2.t, 0.0)
        seg_ok = alive & hit2.valid & (thickness > 1e-6)
        s_max = 1.0 - torch.exp(-thickness / radius)

        for k in range(ns):
            slot = 64 + ((depth * 8 + b) * ns + k) * 2
            u = rng.rand4(lane, sidx, slot, sseed)
            dist = -radius * torch.log(torch.clamp(1.0 - u[..., 0] * s_max, min=1e-20))
            dist = torch.minimum(dist, thickness * (1.0 - 1e-4))
            # 1 / pdf of the truncated exponential distance
            w_dist = radius * s_max * torch.exp(dist / radius) / ns
            v = o_seg + d_seg * dist[..., None]

            u2 = rng.rand4(lane, sidx, slot + 1, sseed)
            ds = em.sample_direct(pack, v, u2[..., :3])

            # the straight exit toward the light, through a boundary nearer
            # than the light
            hit3 = intersect(pack, v, ds.d)
            s_exit = torch.where(hit3.valid, hit3.t, 0.0)
            ok = seg_ok & hit3.valid & (s_exit < ds.dist - 1e-4)

            # Fresnel transmittance at the exit
            its3 = fill_interaction(pack, v, ds.d, hit3)
            cos_x = torch.abs(mm.dot(ds.d, its3.ng))
            fr_out, _, _ = mm.fresnel_dielectric(cos_x, eta)

            # occlusion from the exit point to the emitter
            o_sh = its3.p + ds.d * 1e-4
            rem = torch.where(ds.dist >= em.ENV_DIST, 1e7, (ds.dist - s_exit) * (1.0 - 1e-3))
            occ = occluded(pack, o_sh, ds.d, torch.clamp(rem, min=0.0))
            ok = ok & ~occ & (ds.value.amax(dim=-1) > 0)

            # Henyey-Greenstein at the internal vertex (isotropic at g = 0)
            cos_ph = mm.dot(d_seg, ds.d)
            denom = torch.clamp(1.0 + g * g - 2.0 * g * cos_ph, min=1e-6)
            ph = INV_FOURPI * (1.0 - g * g) / (denom * torch.sqrt(denom))

            att = torch.exp(-sigt * (dist + s_exit)[..., None])
            contrib = ((eta * eta * ph * w_dist)[..., None] * (1.0 - fr_out)[..., None]
                       * thr * sigs * att * ds.value)
            lo = lo + torch.where(ok[..., None], contrib, 0.0)

        if b + 1 >= n_bounce:
            break
        # internal reflection at the far boundary: reflect about its
        # normal, carry F and the segment's attenuation
        # (singlescatter.cpp:1378-1400); the inside branch of the Fresnel
        # term reads a negative cosine
        its2 = fill_interaction(pack, o_seg, d_seg, hit2)
        n2 = its2.ng
        cos2 = mm.dot(d_seg, n2)
        fr2, _, _ = mm.fresnel_dielectric(-torch.abs(cos2), eta)
        d_seg = d_seg - 2.0 * cos2[..., None] * n2
        thr = thr * fr2[..., None]
        thr = thr * torch.exp(-sigt * thickness[..., None])
        o_seg = torch.where(seg_ok[..., None], its2.p + d_seg * 1e-4, o_seg)
        alive = seg_ok & (fr2 > 1e-4)

    return lo


def subsurface_radiance(pack, its, found, thr, L, d_in, lane, sidx, depth, seed):
    """L plus the exitant subsurface radiance at the hits of `found` lanes
    whose material has a subsurface object and that face the viewer
    (reference path.py:155-175 and :389-409): the dipole query on the
    dipole lanes, single scattering on the singlescatter lanes, each
    weighted by thr.  d_in: the incident directions; depth: an int or
    [R].  Each query runs on its own lanes only."""
    sid = pack.mat_sss[torch.clamp(its.mat, min=0)]
    s_kind = pack.sss_kind[torch.clamp(sid, min=0)]
    cos_o = mm.dot(its.ns, its.wi_world)
    is_sss = found & (sid >= 0) & (cos_o > 0)
    if pack.meta.get("sss_has_dipole", True):
        idx = torch.nonzero(is_sss & (s_kind == 0)).squeeze(1)
        if idx.numel():
            lo = sss_lo(pack, its.p[idx], cos_o[idx], sid[idx])
            L = L.index_put((idx,), L[idx] + thr[idx] * lo)
    if pack.meta.get("sss_has_single", False):
        idx = torch.nonzero(is_sss & (s_kind == 1)).squeeze(1)
        if not idx.numel():
            return L
        dep = depth[idx] if isinstance(depth, torch.Tensor) and depth.dim() else depth
        lo = single_scatter_lo(pack, its.p[idx], d_in[idx], its.ng[idx], sid[idx], lane[idx],
                               sidx[idx], dep, seed)
        L = L.index_put((idx,), L[idx] + thr[idx] * lo)
    return L
