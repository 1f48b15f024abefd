"""Volumetric photon mapping with a beam radiance estimate (port of
mitsuba_tpu/integrator/photonmapper.py; reference
src/integrators/photonmapper/photonmapper.cpp:318-338, :395-414 and
bre.cpp:73-183).

* The photon pass is one walk with media: each event either scatters in
  the lane's medium (delta tracking, medium/eval.py) and stores a volume
  photon with the throughput so far, or hits a surface, where a non-null
  hit after at least one real event stores a surface photon.  A `null`
  crossing switches the lane's medium and counts no depth.  RR from the
  third real event on.
* Both maps are hash grids sorted as sppm's (integrator/sppm.py
  `cell_order`).  The volume grid is fixed (extent / VOL_CELL_DIV a
  cell); the surface grid's cell is 2 r_max of the SPPM radii, read on
  the host once per iteration.
* Each volume photon's radius assumes a locally uniform density in its
  own cell: r_i = h cbrt(3 k / (4 pi c_i)), clamped to [0.05 h, 0.35 h].
* The beam query is sampled: BRE_S jittered points along each camera
  medium segment, and a photon whose foot on the ray lies within r_i of a
  point adds tr pow phase K2(d^2 / r^2) / r^2 * len / (2 r_i S).
* The eye pass walks camera rays through null and delta events; in a
  medium the first BRE_EVENTS events add the beam query, and every event
  multiplies in the segment's transmittance.  The first non-delta surface
  takes attenuated NEE and a surface-photon gather with the SPPM
  progression, and the lane stops.

Scenes without media are rendered by render_sppm.  The port keeps the
live photons only (sppm.py says why the maps are the reference's), and
torch has no cube root: the radii take pow(x, 1/3), which moves them in
the last places.  Its fixed-depth loops become host loops over the lanes
still at work, and a window's scan stops at the longest window any lane
reads (the rest add zero).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from mitsuba_tpu_torch.accel.intersect import empty_segments, fill_interaction, intersect
from mitsuba_tpu_torch.bsdf.eval import bsdf_eval, bsdf_sample
from mitsuba_tpu_torch.bsdf.plugins import NULL_BSDF
from mitsuba_tpu_torch.core import lanes, rng
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.gather import take_rows
from mitsuba_tpu_torch.core.lanes import LiveLanes
from mitsuba_tpu_torch.emitter import eval as em
from mitsuba_tpu_torch.integrator import path as _path
from mitsuba_tpu_torch.integrator import sppm as _sppm
from mitsuba_tpu_torch.integrator.ptracer import _sample_emitter_ray
from mitsuba_tpu_torch.integrator.volpath import _attenuated_visibility
from mitsuba_tpu_torch.medium import eval as med_eval
from mitsuba_tpu_torch.scene.texture_eval import shading_frame, shading_params

# beam-query sample points per camera medium segment
BRE_S = int(os.environ.get("MTS_PM_BRE_S", 24))
# bounded per-cell scan windows of the volume and the surface map
# (count / K subsample scaling keeps the estimators unbiased)
VOL_K = int(os.environ.get("MTS_PM_VOL_K", 8))
SURF_K = int(os.environ.get("MTS_PM_SURF_K", 24))
# locally-uniform-density lookup size (bre.cpp's kNN analogue)
VOL_KNN = float(os.environ.get("MTS_PM_KNN", 6.0))
# eye events that run a beam query (each costs one S-point gather)
BRE_EVENTS = int(os.environ.get("MTS_PM_BRE_EVENTS", 4))
# volume grid resolution along the longest scene axis
VOL_CELL_DIV = float(os.environ.get("MTS_PM_VOL_CELL_DIV", 40.0))

_PH_SLOTS = 8
_EYE_SLOTS = 8
_BRE_SLOT_BASE = 4096  # far above ev * _EYE_SLOTS + k of any real depth


def _k2(x):
    """bre.h:63 blurring kernel (normalized over the unit disk)."""
    t = 1.0 - x
    return (3.0 / math.pi) * t * t


def pack_map(origin, g, pp, dd, ww, inv_cell, dims, offset=17, word=1):
    """A photon map: the live photons (global slot indices g, ascending)
    sorted by cell as the reference sorts them (its shuffle hashes the
    slot index + 17 and reads word 1)."""
    cid = _sppm._cell_id(_sppm._grid_cell(pp, origin, inv_cell, dims), dims)
    order, cid_s = _sppm.cell_order(cid, g, word=word, offset=offset)
    return dict(cid=cid_s, p=pp[order], d=dd[order], pow=ww[order])


def bre_radii(cid_s, h_v, r_cap):
    """Per-photon radii from the own-cell population c_i (bre.cpp:73's
    locally uniform density: c_i photons in h^3)."""
    _, count = _sppm.window(cid_s, cid_s)
    c_i = torch.clamp(count.to(torch.float32), min=1.0)
    r_i = h_v * torch.pow(3.0 * VOL_KNN / (4.0 * math.pi * c_i), 1.0 / 3.0)
    return torch.clamp(r_i, 0.05 * h_v, r_cap)


def f32_inverse(x):
    """1 / x in float32 arithmetic, as a host float (the reference divides
    its float32 cell size on the device)."""
    return float(np.float32(1.0) / np.float32(x))


def surface_dims(lo, hi, cell_s, device):
    """The surface grid's dims for the cell size cell_s (a host float):
    ceil(extent / cell_s) per axis, clipped to [1, 1024]."""
    span = torch.tensor(hi - lo, dtype=torch.float32, device=device)
    return torch.clamp(torch.ceil(span / cell_s), 1, 1024).to(torch.int64)


def make_photon_pass(pack, max_depth, seed, device):
    """fn(lane_ph, it, cell_s) -> (vol, surf): the two photon maps
    (dicts of sorted cell ids, positions, directions, powers; vol also
    each photon's radius "r", surf its grid "dims"), and the grid meta,
    whose "stats" the photon and eye passes add to: the rays traced (an
    int64 tensor) and the volume and surface photons stored."""
    present = pack.meta["present_types"]
    max_events = max_depth * 2  # null crossings do not count depth
    lo, hi, extent = _sppm._scene_grid_bounds(pack)
    # the volume grid is fixed: radii shrink the photons' side only
    h_v = extent / VOL_CELL_DIV
    r_cap = 0.35 * h_v
    vdims = tuple(int(min(max(np.ceil((hi[i] - lo[i]) / h_v), 1), 512)) for i in range(3))
    origin = torch.tensor(lo, dtype=torch.float32, device=device)
    vdims_t = torch.tensor(vdims, dtype=torch.int64, device=device)
    seed_l = rng.stream_seed(seed, rng.STREAM_LIGHT)
    stats = {"rays": torch.zeros((), dtype=torch.int64, device=device), "volume_photons": 0,
             "surface_photons": 0}

    def walk(lane_ph, it):
        """The live photons of one pass: ((g, p, d, power) of the volume
        photons, the same of the surface photons)."""
        n_ph = lane_ph.shape[0]
        sidx = torch.full_like(lane_ph, it)
        p0, n0, d0, beta, _, _ = _sample_emitter_ray(pack, lane_ph, sidx, seed)
        o, d = p0 + n0 * 1e-4, d0
        active = beta.amax(dim=-1) > 0
        # photons start outside every medium: an emitter inside one is
        # not modelled (reference emitter->getMedium())
        med = torch.full((n_ph,), -1, dtype=torch.int32, device=device)
        n_real = torch.zeros(n_ph, dtype=torch.int32, device=device)
        lane = lane_ph
        live = LiveLanes(n_ph, device)
        vol, surf = [], []
        for ev in range(max_events):
            if ev % lanes.EXIT_CHECK_EVERY == 0:
                sub = live.narrow(active, o, d, beta, active, med, n_real, lane, sidx)
                if sub is None:
                    break
                o, d, beta, active, med, n_real, lane, sidx = sub
            stats["rays"] = stats["rays"] + active.sum()
            hit = intersect(pack, o, d)
            its = fill_interaction(pack, o, d, hit)
            t_surf = torch.where(its.valid, its.t, 1e8)
            u_m = rng.rand4(lane, sidx, ev * _PH_SLOTS + 2, seed_l)
            ms = med_eval.sample_distance(pack, med, o, d, t_surf, u_m[..., :3], lane, sidx, ev,
                                          seed_l)
            beta = beta * torch.where(active[..., None], ms.weight, 1.0)
            med_evt = active & ms.is_medium
            surf_evt = active & ~ms.is_medium & its.valid
            g = ev * n_ph + live.ids

            # a volume photon at every medium interaction (power with the
            # sigma_s tr / pdf factor, not yet the phase's)
            p_med = o + d * ms.t[..., None]
            vol.append((g, p_med, d, beta, med_evt))

            # a surface photon at a non-null hit after >= 1 real event
            # (the first hit carries direct light, the eye NEE's)
            is_null = take_rows(pack.mat_type, torch.clamp(its.mat, min=0)) == NULL_BSDF
            surf.append((g, its.p, d, beta, surf_evt & ~is_null & (n_real >= 1)))

            u_p = rng.rand4(lane, sidx, ev * _PH_SLOTS + 3, seed_l)
            d_phase, _, ph_w = med_eval.phase_sample(pack, med, d, u_p[..., :2], p=p_med)
            frame = shading_frame(pack, its)
            wi_l = frame.to_local(its.wi_world)
            sp = shading_params(pack, its.mat, its.uv, its=its)
            u_b = rng.rand4(lane, sidx, ev * _PH_SLOTS + 4, seed_l)
            bs = bsdf_sample(sp, wi_l, u_b[..., :2], u_b[..., 2], present)
            d_surf = frame.to_world(bs.wo)
            new_med = torch.where(mm.dot(d_surf, its.ng) < 0, its.med_in, its.med_ex)

            beta = (beta * torch.where(surf_evt[..., None], bs.weight, 1.0)
                    * torch.where(med_evt, ph_w, 1.0)[..., None])
            m3, s3 = med_evt[..., None], surf_evt[..., None]
            o = torch.where(m3, p_med, torch.where(s3, _path._offset_ray(its.p, its.ng, d_surf), o))
            d = torch.where(m3, d_phase, torch.where(s3, d_surf, d))
            med = torch.where(surf_evt, new_med, med)
            n_real = n_real + (med_evt | (surf_evt & ~is_null)).to(torch.int32)

            active = (med_evt | surf_evt) & (beta.amax(dim=-1) > 0) & (n_real < max_depth)
            u_r = rng.rand4(lane, sidx, ev * _PH_SLOTS + 5, seed_l)
            q = torch.clamp(beta.amax(dim=-1), 0.05, 0.95)
            do_rr = n_real >= 3
            keep = torch.where(do_rr, u_r[..., 0] < q, True)
            beta = torch.where((do_rr & keep)[..., None],
                               beta / torch.clamp(q, min=1e-6)[..., None], beta)
            active = active & keep

        def live_of(got):
            if not got:
                e = torch.zeros(0, 3, dtype=torch.float32, device=device)
                return torch.zeros(0, dtype=torch.int64, device=device), e, e, e
            g, p, dd, pw, ok = (torch.cat(x) for x in zip(*got))
            keep = torch.nonzero(ok).squeeze(1)
            return g[keep], p[keep], dd[keep], pw[keep]

        return live_of(vol), live_of(surf)

    def photon_pass(lane_ph, it, cell_s):
        """cell_s: the surface grid's cell (2 r_max of the SPPM radii), a
        host float: the surface grid shrinks with the radii."""
        with torch.profiler.record_function("stage:photon_walk"):
            vol_ph, surf_ph = walk(lane_ph, it)
        stats["volume_photons"] += vol_ph[0].shape[0]
        stats["surface_photons"] += surf_ph[0].shape[0]
        with torch.profiler.record_function("stage:sort"):
            vol = pack_map(origin, *vol_ph, 1.0 / h_v, vdims_t)
            vol["r"] = bre_radii(vol["cid"], h_v, r_cap)
            sdims = surface_dims(lo, hi, cell_s, device)
            surf = pack_map(origin, *surf_ph, f32_inverse(cell_s), sdims)
            surf["dims"] = sdims
        return vol, surf

    meta = dict(lo=lo, hi=hi, extent=extent, h_v=h_v, vdims=vdims, r_cap=r_cap, stats=stats)
    return photon_pass, meta


def _bre_segment(pack, meta, vol, med, o, d, t_end, in_med, lane, sidx, ev, seed, n_shot):
    """The beam radiance estimate over [0, t_end] of each lane's ray where
    in_med: L_med [R, 3]."""
    r = o.shape[0]
    dev = o.device
    S = BRE_S
    origin = torch.tensor(meta["lo"], dtype=torch.float32, device=dev)
    h_v = meta["h_v"]
    vdims = meta["vdims"]

    # jittered stratified points
    n4 = (S + 3) // 4
    u_s = torch.cat([rng.rand4(lane, sidx, _BRE_SLOT_BASE + ev * (n4 + 1) + j, seed)
                     for j in range(n4)], dim=-1)[..., :S]  # [R, S]
    t_s = (torch.arange(S, dtype=torch.float32, device=dev)[None, :] + u_s) / S * t_end[:, None]

    # transmittance at the points: closed form in homogeneous media, the
    # midpoint sums of the density in heterogeneous ones
    m = torch.clamp(med, min=0)
    sigma_t = pack.med_sigma_s[m] + pack.med_sigma_a[m]  # [R, 3]
    tr_s = torch.exp(-sigma_t[:, None, :] * t_s[..., None])  # [R, S, 3]
    x_s = o[:, None, :] + d[:, None, :] * t_s[..., None]  # [R, S, 3]
    if pack.meta.get("n_het", 0) > 0:
        hp = med_eval._het_params(pack, med)
        hp_k = med_eval._expand(hp)
        dens = med_eval._het_density_q(pack, hp_k, med_eval._to_grid(hp_k, x_s))  # [R, S]
        dt = (t_end / S)[:, None]
        tau = (med_eval._cumsum(dens) - 0.5 * dens) * dt
        tr_het = torch.exp(-tau)[..., None] * torch.ones(1, 1, 3, device=dev)
        tr_s = torch.where((hp["slot"] >= 0)[:, None, None], tr_het, tr_s)

    # one gather lane per (ray, point) pair
    xf = x_s.reshape(r * S, 3)
    of = o.repeat_interleave(S, dim=0)
    df = d.repeat_interleave(S, dim=0)
    medf = med.repeat_interleave(S, dim=0)
    tendf = t_end.repeat_interleave(S, dim=0)
    tsf = t_s.reshape(r * S)
    trf = tr_s.reshape(r * S, 3)
    okf = in_med.repeat_interleave(S, dim=0)

    vq0 = torch.floor((xf - origin) * (1.0 / h_v) - 0.5).to(torch.int64)
    dims_a = torch.tensor(vdims, dtype=torch.int64, device=dev)
    cid_s = vol["cid"]
    P = cid_s.shape[0]
    acc = torch.zeros(r * S, 3, dtype=torch.float32, device=dev)
    for off in _sppm.NEIGHBOURS:
        qn = vq0 + torch.tensor(off, dtype=torch.int64, device=dev)
        ok_cell = okf & ((qn >= 0) & (qn < dims_a)).all(dim=-1)
        cc = (qn[..., 2] * vdims[1] + qn[..., 1]) * vdims[0] + qn[..., 0]
        start, count = _sppm.window(cid_s, cc)
        scale = torch.clamp(count.to(torch.float32) / VOL_K, min=1.0)
        n_k = min(VOL_K, int(torch.where(ok_cell, count, 0).amax())) if P else 0
        for k in range(n_k):
            idx = torch.clamp(start + k, max=P - 1)
            in_w = ok_cell & (k < count)
            pp, pd, pw, pr = vol["p"][idx], vol["d"][idx], vol["pow"][idx], vol["r"][idx]
            t_proj = mm.dot(pp - of, df)
            foot = of + df * t_proj[..., None]
            d2 = ((pp - foot) ** 2).sum(dim=-1)
            r2 = pr * pr
            sel = (in_w & (t_proj > 0.0) & (t_proj < tendf) & (d2 < r2)
                   & (torch.abs(t_proj - tsf) < pr))
            ph = med_eval.phase_eval(pack, medf, pd, -df, p=xf)
            w = (_k2(d2 / torch.clamp(r2, min=1e-20)) / torch.clamp(r2, min=1e-20)
                 * tendf / (2.0 * torch.clamp(pr, min=1e-20) * S) * scale)
            contrib = pw * (ph * w)[..., None] * trf
            acc = acc + torch.where(sel[..., None], contrib, 0.0)
    return acc.reshape(r, S, 3).sum(dim=1) / n_shot


def make_eye_pass(pack, integ, sen, w, h, seed, meta, device):
    """fn(lane_px, it, vol, surf, r2, n_shot, cell_s) -> (L, M, tau_i)."""
    present = pack.meta["present_types"]
    max_depth = _sppm.max_depth_of(integ)
    cam = sen.pack(w, h, device)
    lo = torch.tensor(meta["lo"], dtype=torch.float32, device=device)
    stats = meta["stats"]

    def eye_pass(lane_px, it, vol, surf, r2, n_shot, cell_s):
        n = lane_px.shape[0]
        sidx = torch.full_like(lane_px, it)
        o, d = _sppm.camera_rays(sen, cam, w, h, lane_px, sidx,
                                 _sppm.eye_lens_draw(sen.sampler, lane_px, sidx))
        L = torch.zeros(n, 3, dtype=torch.float32, device=device)
        thr = torch.ones(n, 3, dtype=torch.float32, device=device)
        active = torch.ones(n, dtype=torch.bool, device=device)
        med = torch.full((n,), pack.meta["camera_medium"], dtype=torch.int32, device=device)
        M = torch.zeros(n, dtype=torch.float32, device=device)
        tau_i = torch.zeros(n, 3, dtype=torch.float32, device=device)
        stored = torch.zeros_like(active)
        outs = [torch.zeros_like(x) for x in (L, M, tau_i)]
        live = LiveLanes(n, device)
        for ev in range(max_depth):
            if ev % lanes.EXIT_CHECK_EVERY == 0:
                live.write(outs, (L, M, tau_i))
                sub = live.narrow(active, L, M, tau_i, thr, active, med, stored, o, d, r2,
                                  lane_px, sidx)
                if sub is None:
                    break
                L, M, tau_i, thr, active, med, stored, o, d, r2, lane_px, sidx = sub
            stats["rays"] = stats["rays"] + active.sum()
            hit = intersect(pack, o, d)
            its = fill_interaction(pack, o, d, hit)
            t_end = torch.where(its.valid, its.t, 1e4)
            in_med = active & (med >= 0)

            # in-medium radiance: the beam query over the segment
            if ev < BRE_EVENTS:
                with torch.profiler.record_function("stage:bre"):
                    L_med = _bre_segment(pack, meta, vol, med, o, d, t_end, in_med, lane_px,
                                         sidx, ev, seed, n_shot)
                L = L + torch.where(in_med[..., None], thr * L_med, 0.0)

            # the segment's transmittance
            tr = med_eval.transmittance(pack, med, o, d, t_end, lane_px, sidx,
                                        _BRE_SLOT_BASE // 2 + ev, seed)
            thr = thr * torch.where(in_med[..., None], tr, 1.0)

            # escapes and emitter hits (only delta chains reach them
            # before the visible point: weight 1; photons never land on
            # emitters or the environment)
            if pack.meta.get("has_env", False):
                esc = active & ~its.valid
                L = L + torch.where(esc[..., None], thr * em.eval_env(pack, d), 0.0)
            if pack.meta["has_area"]:
                cos_l = mm.dot(its.ns, its.wi_world)
                emis = active & its.valid & (its.emit >= 0) & (cos_l > 0)
                le = take_rows(pack.em_rgb, torch.clamp(its.emit, min=0))
                L = L + torch.where(emis[..., None], thr * le, 0.0)

            active = active & its.valid
            is_null = take_rows(pack.mat_type, torch.clamp(its.mat, min=0)) == NULL_BSDF
            sp = shading_params(pack, its.mat, its.uv, its=its)
            frame = shading_frame(pack, its)
            wi_l = frame.to_local(its.wi_world)
            delta = _sppm.is_delta(sp)
            vp_here = active & ~is_null & ~delta & ~stored

            # direct NEE at the visible point, attenuated through media
            if pack.meta["n_emitters"] > 0:
                u_n = rng.rand4(lane_px, sidx, ev * _EYE_SLOTS + 1, seed)
                ds = em.sample_direct(pack, its.p, u_n[..., :3])
                f = bsdf_eval(sp, wi_l, frame.to_local(ds.d), present)
                o_sh = _path._offset_ray(its.p, its.ng, ds.d)
                med_sh = torch.where(mm.dot(ds.d, its.ng) < 0, its.med_in, its.med_ex)
                sh_t = torch.where(ds.dist >= em.ENV_DIST, 1e7, ds.dist * (1.0 - 1e-3))
                # the other lanes (whose p may be inf past an escape) trace
                # an empty segment, whose result they do not read
                o_sh, d_sh, sh_t = empty_segments(pack, vp_here, o_sh, ds.d, sh_t)
                tr_sh, _ = _attenuated_visibility(pack, o_sh, d_sh, sh_t, med_sh, lane_px, sidx,
                                                  ev + 64, seed)
                stats["rays"] = stats["rays"] + vp_here.sum()
                L = L + torch.where(vp_here[..., None], thr * ds.value * tr_sh * f, 0.0)

            # the surface photon gather (SPPM progression)
            if bool(vp_here.any()):
                with torch.profiler.record_function("stage:gather"):
                    vq0 = torch.floor((its.p - lo) * f32_inverse(cell_s) - 0.5).to(torch.int64)
                    M, tau_i, _ = _sppm.gather_windows(
                        pack, (surf["cid"], surf["p"], surf["d"], surf["pow"]), SURF_K, its.p,
                        vp_here, vq0, surf["dims"], r2, sp, frame, wi_l, thr, M, tau_i)
            stored = stored | vp_here

            # null and delta lanes walk on
            cont = active & (is_null | delta) & ~stored
            u_b = rng.rand4(lane_px, sidx, ev * _EYE_SLOTS + 2, seed)
            bs = bsdf_sample(sp, wi_l, u_b[..., :2], u_b[..., 2], present)
            n3 = is_null[..., None]
            d_new = torch.where(n3, d, frame.to_world(bs.wo))
            w_new = torch.where(n3, torch.ones_like(bs.weight), bs.weight)
            c3 = cont[..., None]
            thr = thr * torch.where(c3, w_new, 1.0)
            crossing = mm.dot(d_new, its.ng) < 0
            med = torch.where(cont, torch.where(crossing, its.med_in, its.med_ex), med)
            o = torch.where(c3, _path._offset_ray(its.p, its.ng, d_new), o)
            d = torch.where(c3, d_new, d)
            active = cont & (thr.amax(dim=-1) > 0)
        else:
            live.write(outs, (L, M, tau_i))
        return tuple(outs)

    return eye_pass


def iter_photonmapper(scene, pack, spp=None, seed=0, photons_per_pass=None, device="cuda",
                      timed=False):
    """The volumetric photon mapper iteration by iteration on `device`
    (a scene with media): yields (image [H, W, 3] tensor, iterations done,
    stats) after each iteration; stats holds the rays traced (an int64
    tensor), the volume and surface photons stored and, with `timed`, the
    seconds of each photon and eye pass (host clock around each pass,
    ended by a synchronise)."""
    import time

    device = torch.device(device)
    sen = scene.sensor.record
    w, h = sen.film.width, sen.film.height
    n_px = w * h
    n_iters = spp or sen.sampler.sample_count
    n_photons = _sppm.photons_per_pass_of(photons_per_pass, 1 << 17)
    max_depth = _sppm.max_depth_of(scene.integrator)
    photon_pass, meta = make_photon_pass(pack, max_depth, seed, device)
    eye_pass = make_eye_pass(pack, scene.integrator, sen, w, h, seed, meta, device)
    r0 = _sppm.initial_radius(meta["extent"], w, h)
    lane_px = torch.arange(n_px, dtype=torch.int64, device=device)
    lane_ph = torch.arange(n_photons, dtype=torch.int64, device=device)
    r2 = torch.full((n_px,), r0 * r0, dtype=torch.float32, device=device)
    N = torch.zeros(n_px, dtype=torch.float32, device=device)
    tau = torch.zeros(n_px, 3, dtype=torch.float32, device=device)
    L_direct = torch.zeros(n_px, 3, dtype=torch.float32, device=device)
    stats = meta["stats"]
    stats.update(photon_s=[], eye_s=[])

    def clock():
        if timed and device.type == "cuda":
            torch.cuda.synchronize()
        return time.time()

    for it in range(n_iters):
        # the surface grid's cell follows the shrinking radii: one host
        # read per iteration
        t0 = clock()
        cell_s = float(np.float32(2.0 * max(float(torch.sqrt(r2.amax())), 1e-6)))
        vol, surf = photon_pass(lane_ph, it, cell_s)
        t1 = clock()
        with torch.profiler.record_function("stage:eye"):
            L_i, M, tau_i = eye_pass(lane_px, it, vol, surf, r2, float(n_photons), cell_s)
        t2 = clock()
        if timed:
            stats["photon_s"].append(t1 - t0)
            stats["eye_s"].append(t2 - t1)
        L_direct = L_direct + L_i
        N, tau, r2 = _sppm.progress(N, tau, r2, M, tau_i)
        yield (_sppm.radiance(L_direct, it + 1, tau, r2, (it + 1) * n_photons).reshape(h, w, 3),
               it + 1, stats)


def render_photonmapper(scene, spp=None, seed=0, pack=None, photons_per_pass=None,
                        device="cuda"):
    """The volumetric photon mapper on `device`: `spp` iterations of
    photons_per_pass photons (MTS_SPPM_PHOTONS, 2^17 by default); scenes
    without media are rendered by render_sppm with its own default count,
    photons_per_pass dropped, as the reference does
    (photonmapper.py:612-615).
    Returns numpy [H, W, 3]; the last iteration's stats are left in
    render_photonmapper.last_stats."""
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device)
    if pack is None:
        pack = pack_scene(scene, device)
    if not pack.meta.get("has_media", False):
        return _sppm.render_sppm(scene, spp=spp, seed=seed, pack=pack, device=device)
    sen = scene.sensor.record
    if pack.meta["n_emitters"] == 0:
        return np.zeros((sen.film.height, sen.film.width, 3), np.float32)
    img, stats = None, None
    for img, _, stats in iter_photonmapper(scene, pack, spp, seed, photons_per_pass, device):
        pass
    render_photonmapper.last_stats = stats
    return img.cpu().numpy()


render_photonmapper.last_stats = None
