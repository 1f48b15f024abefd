"""Irradiance caching (port of mitsuba_tpu/integrator/irrcache.py,
reference src/integrators/misc/irrcache.cpp and
include/mitsuba/render/irrcache.h:44).

The reference inserts records adaptively into an octree during an
overture pass and interpolates them with Ward's weights w_i = 1 /
(|x - x_i| / R_i + sqrt(1 - n.n_i)).  The wavefront form, which this port
keeps, makes the record set static:

* overture (`_overture`): the first diffuse hits of a stride-STRIDE pixel
  subgrid become the records.  Each gathers GRID_M x GRID_N
  cosine-stratified rays traced by the path tracer with its depth-0
  emitters hidden (indirect light only: direct light stays a one-sample
  NEE at render time), which give its irradiance, its Ward-Heckbert
  translational and rotational gradients, and its radius R_i, the
  harmonic mean of the gather rays' hit distances;
* render (`irrcache_trace`): one camera ray a pixel and pass; a diffuse
  hit takes its emission, one NEE sample and albedo / pi times the
  gradient-corrected, Ward-weighted blend of the records (`_interp`, a
  dense sum over the records, CHUNK records a step); any other hit falls
  back to the nested integrator's full path trace, which runs on those
  lanes only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mitsuba_tpu_torch.accel.intersect import fill_interaction, intersect, occluded
from mitsuba_tpu_torch.bsdf.eval import bsdf_eval
from mitsuba_tpu_torch.bsdf.plugins import DIFFUSE
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.core.gather import take_rows
from mitsuba_tpu_torch.emitter import eval as em
from mitsuba_tpu_torch.integrator.path import _offset_ray, path_trace
from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord
from mitsuba_tpu_torch.scene.texture_eval import mip_footprint, shading_frame, shading_params
from mitsuba_tpu_torch.sensor.plugins import generate_rays

# records per step of the dense interpolation (the reference's step)
CHUNK = 128
# lanes per block of the interpolation: a step's [lanes, CHUNK, 3] float32
# temporaries stay at ~100 MB each
LANE_BLOCK = 1 << 16
STRIDE = 4  # the overture's pixel subgrid stride
# the stratified hemisphere grid (theta x phi) of a record's gather rays
# (reference irrcache.cpp HemisphereSampler; Ward & Heckbert 1992)
GRID_M = 8
GRID_N = 16
GATHER_K = GRID_M * GRID_N


def _sub(integ):
    return integ.sub_integrator or IntegratorRecord(kind="path")


def _hemisphere_gradients(li, rdist, t1, t2, nrm):
    """Irradiance and the Ward-Heckbert gradients of a record from its
    cosine-stratified M x N gather (reference irrcache.py:56-115,
    irrcache.h:128).  li [m, M, N, 3]: radiance per cell; rdist [m, M, N]:
    hit distance per cell; t1, t2, nrm [m, 3]: the record's frame.
    Returns (E [m, 3], grad_t [m, 3, 3], grad_r [m, 3, 3]), the gradients
    indexed (spatial axis, channel): E(p, n) ~ E_i + grad_t . (p - p_i) +
    grad_r . (n_i x n)."""
    dev = li.device
    j = torch.arange(GRID_M, dtype=torch.float32, device=dev)
    k = torch.arange(GRID_N, dtype=torch.float32, device=dev)
    sin_lo = torch.sqrt(j / GRID_M)  # sin(theta_j-)
    sin_hi = torch.sqrt((j + 1.0) / GRID_M)
    cos2_lo = 1.0 - sin_lo * sin_lo
    theta_c = torch.arcsin(torch.sqrt((j + 0.5) / GRID_M))
    phi_c = 2.0 * math.pi * (k + 0.5) / GRID_N
    # the cells' azimuth directions in the tangent frame [m, N, 3]
    cph, sph = torch.cos(phi_c)[None, :, None], torch.sin(phi_c)[None, :, None]
    u_k = cph * t1[:, None, :] + sph * t2[:, None, :]
    v_k = -sph * t1[:, None, :] + cph * t2[:, None, :]

    e = (math.pi / GATHER_K) * li.sum(dim=(1, 2))

    # translational gradient: the radial (theta-neighbour) and tangential
    # (phi-neighbour) cell-boundary terms, each over the nearer of the two
    # cells' hit distances
    r_safe = torch.clamp(rdist, min=1e-4)
    dl_th = li[:, 1:] - li[:, :-1]  # [m, M-1, N, 3]
    rmin_th = torch.minimum(r_safe[:, 1:], r_safe[:, :-1])
    coef_th = (2.0 * math.pi / GRID_N) * (sin_lo * cos2_lo)[1:]
    rad = ((coef_th[None, :, None] / rmin_th)[..., None] * dl_th).sum(dim=1)  # [m, N, 3]
    dl_ph = li - torch.roll(li, 1, dims=2)
    rmin_ph = torch.minimum(r_safe, torch.roll(r_safe, 1, dims=2))
    coef_ph = sin_hi - sin_lo
    tan_g = ((coef_ph[None, :, None] / rmin_ph)[..., None] * dl_ph).sum(dim=1)
    grad_t = (u_k[..., None] * rad[:, :, None, :]
              + v_k[..., None] * tan_g[:, :, None, :]).sum(dim=1)

    # rotational gradient: pi / (M N) * sum tan(theta_j) L_jk about v_k
    rot = (torch.tan(theta_c)[None, :, None, None] * li).sum(dim=1)  # [m, N, 3]
    grad_r = (math.pi / GATHER_K) * (v_k[..., None] * rot[:, :, None, :]).sum(dim=1)
    return e, grad_t, grad_r


def _overture(pack, integ, cam_rays, seed):
    """The record set from a subgrid of camera rays (reference
    irrcache.py:118-185).  Returns (pos [m, 3], nrm [m, 3], e_ind [m, 3],
    r_i [m], valid [m], grad_t [m, 3, 3], grad_r [m, 3, 3]) and the rays
    traced (an int64 tensor)."""
    o, d = cam_rays
    hit = intersect(pack, o, d)
    its = fill_interaction(pack, o, d, hit)
    sp = shading_params(pack, its.mat, its.uv, its=its)
    diffuse = its.valid & (sp["type"] == DIFFUSE)

    m = o.shape[0]
    dev = o.device
    sseed = rng.stream_seed(seed, rng.STREAM_SSS) ^ 0x1CC
    lane = torch.arange(m, dtype=torch.int64, device=dev).repeat_interleave(GATHER_K)
    cell = torch.arange(GATHER_K, dtype=torch.int64, device=dev).repeat(m)
    sidx = cell
    p_l = its.p.repeat_interleave(GATHER_K, dim=0)
    n_l = its.ns.repeat_interleave(GATHER_K, dim=0)

    # cosine-stratified cells: cell (j, k) jittered within its bounds
    cj = (cell // GRID_N).to(torch.float32)
    ck = (cell % GRID_N).to(torch.float32)
    u2 = rng.rand4(lane, sidx, 0, sseed)[..., :2]
    xi1 = (cj + u2[..., 0]) / GRID_M
    xi2 = (ck + u2[..., 1]) / GRID_N
    sin_t = torch.sqrt(xi1)
    cos_t = torch.sqrt(torch.clamp(1.0 - xi1, min=0.0))
    phi = 2.0 * math.pi * xi2
    dirs = mm.Frame.from_normal(n_l).to_world(
        torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1))
    o_g = p_l + n_l * 1e-4
    integ_ind = dataclasses.replace(integ, kind="path", hide_emitters=True, max_depth=6)
    li = path_trace(pack, integ_ind, o_g, dirs, lane, sidx, None, seed=sseed)
    n_rays = m + path_trace.last_ray_count + o_g.shape[0]

    g_hit = intersect(pack, o_g, dirs)
    g_t = torch.where(g_hit.t < 1e6, g_hit.t, 1e6)

    fr_rec = mm.Frame.from_normal(its.ns)
    e_ind, grad_t, grad_r = _hemisphere_gradients(
        li.reshape(m, GRID_M, GRID_N, 3), g_t.reshape(m, GRID_M, GRID_N),
        fr_rec.s, fr_rec.t, its.ns)

    # the validity radius: the harmonic mean of the gather rays' distances
    # (irrcache.h:44)
    r_i = GATHER_K / (1.0 / torch.clamp(g_t, min=1e-4)).reshape(m, GATHER_K).sum(dim=1)
    # records off diffuse surfaces carry NaN frames and may carry inf
    # positions (missed camera rays): zeroed, since interpolation weights
    # of 0 cannot cancel 0 * NaN or inf * 0
    ok = diffuse[..., None, None]
    grad_t = torch.where(ok, torch.nan_to_num(grad_t), 0.0)
    grad_r = torch.where(ok, torch.nan_to_num(grad_r), 0.0)
    p_rec = torch.where(diffuse[..., None], torch.nan_to_num(its.p, posinf=0.0, neginf=0.0),
                        0.0)
    return (p_rec, its.ns, e_ind, r_i, diffuse, grad_t, grad_r), n_rays


def _interp_block(pos, nrm, e_ind, r_i, valid, grad_t, grad_r, p, n):
    """_interp's sums for one block of lanes."""
    num = torch.zeros(p.shape[0], 3, dtype=torch.float32, device=p.device)
    den = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
    for c0 in range(0, pos.shape[0], CHUNK):
        cp, cn, ce = pos[c0:c0 + CHUNK], nrm[c0:c0 + CHUNK], e_ind[c0:c0 + CHUNK]
        cr, cv = r_i[c0:c0 + CHUNK], valid[c0:c0 + CHUNK]
        cgt, cgr = grad_t[c0:c0 + CHUNK], grad_r[c0:c0 + CHUNK]
        dvec = p[:, None, :] - cp[None, :, :]
        dist = torch.sqrt((dvec * dvec).sum(dim=-1))
        ndot = torch.clamp((n[:, None, :] * cn[None, :, :]).sum(dim=-1), -1.0, 1.0)
        # Ward's error heuristic (irrcache.h computeWeight); records facing
        # away add nothing
        w = 1.0 / (dist / torch.clamp(cr[None, :], min=1e-4)
                   + torch.sqrt(torch.clamp(1.0 - ndot, min=0.0)) + 1e-3)
        w = torch.where(cv[None, :] & (ndot > 0.1), w, 0.0)
        # first-order extrapolation to (p, n), clamped at zero
        cross = torch.cross(cn[None, :, :].expand_as(dvec), n[:, None, :].expand_as(dvec),
                            dim=-1)
        e_corr = (ce[None, :, :] + torch.einsum("lcs,csk->lck", dvec, cgt)
                  + torch.einsum("lcs,csk->lck", cross, cgr))
        e_corr = torch.clamp(e_corr, min=0.0)
        num = num + (w[..., None] * e_corr).sum(dim=1)
        den = den + w.sum(dim=1)
    return num, den


def _interp(pos, nrm, e_ind, r_i, valid, p, n, grad_t=None, grad_r=None):
    """The Ward-weighted blend of the records at (p [R, 3], n [R, 3]),
    each record corrected to first order, E_i + grad_t . (p - p_i) +
    grad_r . (n_i x n) (reference irrcache.py:188-254).  Returns (E [R, 3],
    the weight sum [R])."""
    m = pos.shape[0]
    if grad_t is None:
        grad_t = torch.zeros(m, 3, 3, dtype=torch.float32, device=pos.device)
    if grad_r is None:
        grad_r = torch.zeros(m, 3, 3, dtype=torch.float32, device=pos.device)
    parts = [_interp_block(pos, nrm, e_ind, r_i, valid, grad_t, grad_r,
                           p[b:b + LANE_BLOCK], n[b:b + LANE_BLOCK])
             for b in range(0, p.shape[0], LANE_BLOCK)]
    num = torch.cat([q[0] for q in parts]) if parts else p.new_zeros(0, 3)
    den = torch.cat([q[1] for q in parts]) if parts else p.new_zeros(0)
    return num / torch.clamp(den, min=1e-6)[..., None], den


def irrcache_trace(pack, integ, o, d, lane, sample_idx, sampler, seed=0, cache=None):
    """The render pass's trace (reference irrcache.py:257-325): diffuse
    hits use the cache, the others the nested integrator's path trace.
    Without a cache this is the nested path trace.  The rays traced are
    left in irrcache_trace.last_ray_count."""
    sub = _sub(integ)
    if cache is None:
        out = path_trace(pack, sub, o, d, lane, sample_idx, sampler, seed)
        irrcache_trace.last_ray_count = path_trace.last_ray_count
        return out
    pos, nrm, e_ind, r_i, valid, grad_t, grad_r = cache

    r = o.shape[0]
    hit = intersect(pack, o, d)
    its = fill_interaction(pack, o, d, hit)
    frame = shading_frame(pack, its)
    wi_l = frame.to_local(its.wi_world)
    sp = shading_params(pack, its.mat, its.uv, mip_footprint(pack, its), its=its)
    diffuse = its.valid & (sp["type"] == DIFFUSE)
    n_rays = torch.tensor(r, dtype=torch.int64, device=o.device)

    L = torch.zeros(r, 3, dtype=torch.float32, device=o.device)
    # emitted and environment radiance along the camera rays
    if pack.meta.get("has_env", False):
        L = L + torch.where((~its.valid)[..., None], em.eval_env(pack, d), 0.0)
    if pack.meta["has_area"]:
        cos_l = mm.dot(its.ns, its.wi_world)
        emissive = its.valid & (its.emit >= 0) & (cos_l > 0)
        le = take_rows(pack.em_rgb, torch.clamp(its.emit, min=0))
        L = L + torch.where(emissive[..., None], le, 0.0)

    # direct light: one NEE sample (no BSDF sampling of emitters, so no
    # MIS), from a stream of its own so that it cannot alias the fallback
    # path's depth-0 NEE draw
    if pack.meta["n_emitters"] > 0:
        u_n = rng.rand4(lane, sample_idx, 1, rng.stream_seed(seed, rng.STREAM_SSS) ^ 0xD1)
        ds = em.sample_direct(pack, its.p, u_n[..., :3])
        f = bsdf_eval(sp, wi_l, frame.to_local(ds.d), pack.meta["present_types"])
        shadow_t = torch.where(ds.dist >= em.ENV_DIST, 1e7, ds.dist * 0.999)
        occ = occluded(pack, _offset_ray(its.p, its.ng, ds.d), ds.d, shadow_t)
        n_rays = n_rays + r
        L = L + torch.where((diffuse & ~occ)[..., None], ds.value * f, 0.0)

    # indirect: the interpolated irradiance times albedo / pi
    e_interp, _ = _interp(pos, nrm, e_ind, r_i, valid, its.p, its.ns, grad_t, grad_r)
    L = L + torch.where(diffuse[..., None], sp["cA"] * (1.0 / math.pi) * e_interp, 0.0)

    # the other hits: the nested path trace, on their lanes only
    idx = torch.nonzero(its.valid & ~diffuse).squeeze(1)
    if idx.numel():
        fb = path_trace(pack, sub, o[idx], d[idx], lane[idx], sample_idx[idx], sampler, seed)
        n_rays = n_rays + path_trace.last_ray_count
        L = L.index_put((idx,), fb)
    irrcache_trace.last_ray_count = n_rays
    return L


def build_cache(pack, integ, make_subgrid_rays, seed=0):
    """The overture on the stride-STRIDE pixel subgrid: the record tuple
    and the rays traced."""
    o, d = make_subgrid_rays(STRIDE)
    return _overture(pack, _sub(integ), (o, d), seed)


def render_irrcache(scene, spp=None, seed=0, pack=None, device="cuda"):
    """The overture on a stride-4 subgrid, then spp passes of one camera
    ray a pixel through irrcache_trace (reference irrcache.py:340-388).
    Returns numpy [H, W, 3]; the record count and the rays traced by the
    overture, by the passes and by both are left in
    render_irrcache.last_stats."""
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device)
    if pack is None:
        pack = pack_scene(scene, device)
    sensor = scene.sensor.record
    sampler = sensor.sampler
    w, h = sensor.film.width, sensor.film.height
    spp = spp or sampler.sample_count
    cam = sensor.pack(w, h, device)
    integ = scene.integrator

    def make_subgrid_rays(stride):
        xs = (torch.arange(w // stride, device=device) * stride + 0.5) / w
        ys = (torch.arange(h // stride, device=device) * stride + 0.5) / h
        gx, gy = torch.meshgrid(xs.to(torch.float32), ys.to(torch.float32), indexing="xy")
        pos01 = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
        return generate_rays(cam, pos01, torch.zeros_like(pos01))

    cache, overture_rays = build_cache(pack, integ, make_subgrid_rays, seed)

    n_px = w * h
    lane = torch.arange(n_px, dtype=torch.int64, device=device)
    px_x, px_y = (lane % w).to(torch.float32), (lane // w).to(torch.float32)
    acc = np.zeros((n_px, 3), np.float32)
    pass_rays = 0
    for s in range(spp):
        sidx = torch.full((n_px,), s, dtype=torch.int64, device=device)
        u2 = sampler.pixel_sample(lane, sidx, spp)
        pos01 = torch.stack([(px_x + u2[..., 0]) / w, (px_y + u2[..., 1]) / h], dim=-1)
        o, d = generate_rays(cam, pos01, torch.zeros_like(u2))
        acc += irrcache_trace(pack, integ, o, d, lane, sidx, sampler, seed, cache).cpu().numpy()
        pass_rays += int(irrcache_trace.last_ray_count)
    render_irrcache.last_stats = {"records": cache[0].shape[0],
                                  "overture_rays": int(overture_rays), "pass_rays": pass_rays,
                                  "rays": int(overture_rays) + pass_rays}
    return (acc / spp).reshape(h, w, 3)


render_irrcache.last_stats = None
