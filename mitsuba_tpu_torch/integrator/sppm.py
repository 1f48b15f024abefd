"""Stochastic progressive photon mapping (port of
mitsuba_tpu/integrator/sppm.py, reference
src/integrators/photonmapper/sppm.cpp:72-92); `ppm` runs the same code.

Each iteration is two wavefront passes over the whole film:

* the eye pass walks one camera ray per pixel through delta surfaces to
  its first non-delta surface, the pixel's visible point, adding emitted
  and environment radiance (with MIS against the BSDF draws of the delta
  chain) and one NEE sample there;
* the photon pass shoots photons from the emitters and walks them (RR
  after depth 3); every surface hit from depth 1 on stores a photon (the
  eye pass's NEE carries direct light).  The photons are sorted by the
  cell of a hash grid whose cell is 2 r_max (a pcg4d shuffle of their
  indices, then a stable sort by cell, so that a cell's first K photons
  are an unbiased subsample of it), and each visible point scans the
  first PHOTONS_PER_CELL photons of each cell of its 2x2x2 neighbourhood,
  scaling a fuller cell's photons by count / K.

The radius and flux follow Hachisuka and Jensen (2009): alpha = 0.7,
N += alpha M, r^2 and tau scaled by (N + alpha M) / (N + M).

The reference stores every (depth, photon) slot and sorts the dead ones
last under a sentinel cell; the port keeps the live photons only, with
the global index depth * n_photons + photon that keys the shuffle, so the
sorted photons and every window are the reference's.  Its fixed-depth
loops become host loops over the lanes still at work (core/lanes.py),
and a window's scan stops at the longest window any visible point reads
(the rest add zero).  The decision uniforms are `rand4(pixel, iteration,
depth * 4 + slot)` (NEE slot 1, BSDF slot 2) in the eye pass and the
light stream's `rand4(photon, iteration, depth * 4 + slot)` (BSDF 2, RR 3)
in the photon pass, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mitsuba_tpu_torch.accel.intersect import (
    empty_segments,
    fill_interaction,
    intersect,
    occluded,
)
from mitsuba_tpu_torch.bsdf.eval import DELTA_TYPES, bsdf_eval, bsdf_sample
from mitsuba_tpu_torch.core import lanes, rng
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.lanes import LiveLanes
from mitsuba_tpu_torch.emitter import eval as em
from mitsuba_tpu_torch.integrator import path as _path
from mitsuba_tpu_torch.integrator.ptracer import _sample_emitter_ray
from mitsuba_tpu_torch.scene.texture_eval import shading_frame, shading_params
from mitsuba_tpu_torch.sensor.plugins import generate_rays

ALPHA = 0.7  # radius-shrink exponent (reference sppm.cpp:92)
PHOTONS_PER_CELL = 32  # bounded per-cell scan window
_EYE_SLOTS = 4
_PH_SLOTS = 4
SHADOW_EPS = 1e-3
# the neighbourhood's cells in the reference's order (dz, dy, dx)
NEIGHBOURS = tuple((dx, dy, dz) for dz in range(2) for dy in range(2) for dx in range(2))


def _grid_cell(p, origin, inv_cell, dims):
    """Integer cell coordinates [.., 3] (int64), clamped into the grid."""
    q = torch.floor((p - origin) * inv_cell).to(torch.int64)
    return torch.minimum(torch.clamp(q, min=0), dims - 1)


def _cell_id(q, dims):
    return (q[..., 2] * dims[1] + q[..., 1]) * dims[0] + q[..., 0]


def _scene_grid_bounds(pack):
    """Hash-grid bounds (float32 [3] lo, hi) and the scene's extent, from
    the real triangles (the tables are padded past n_tris with far
    sentinels)."""
    nt = int(pack.meta["n_tris"])
    v0 = pack.tri_v0[:nt].cpu().numpy()
    v1 = v0 + pack.tri_e1[:nt].cpu().numpy()
    v2 = v0 + pack.tri_e2[:nt].cpu().numpy()
    pts = np.concatenate([v0, v1, v2], axis=0)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = float(np.max(hi - lo)) or 1.0
    return lo, hi, extent


def cell_order(cid, g, word=0, offset=0):
    """The photons' order in the map: (order, sorted cell ids).  g: each
    photon's index in the reference's depth-major list of every (depth,
    photon) slot, ascending.  A pcg4d hash of g + offset (word `word` of
    its four) shuffles the photons, and a stable sort by cell follows;
    both sorts are stable, so ties keep the order of g, as in the
    reference (the dead slots it sorts last under a sentinel cell change
    neither)."""
    n = g.shape[0]
    key = rng.pcg4d((g + offset)[:, None].expand(n, 4))[:, word]
    shuffle = torch.argsort(key, stable=True)
    cs = cid[shuffle]
    by_cell = torch.argsort(cs, stable=True)
    return shuffle[by_cell], cs[by_cell]


def window(cid_s, c):
    """(start, count) of cell ids c in the sorted cell ids cid_s."""
    c = c.contiguous()
    start = torch.searchsorted(cid_s, c, right=False)
    return start, torch.searchsorted(cid_s, c, right=True) - start


def is_delta(sp):
    out = torch.zeros_like(sp["type"], dtype=torch.bool)
    for t in DELTA_TYPES:
        out = out | (sp["type"] == t)
    return out


def max_depth_of(integ):
    return integ.max_depth if integ.max_depth > 0 else 12


def eye_lens_draw(sampler, lane_px, sidx):
    """The eye pass's lens draw of sppm and the photon mapper (reference
    sppm.py:111-113, photonmapper.py:426-428): slot 1009 of the
    sampler's counter stream, whatever the sampler."""
    return sampler.next2d(lane_px, sidx, 1009)


def camera_rays(sen, cam, w, h, lane_px, sidx, u_lens):
    """One camera ray per pixel lane (sample index sidx), jittered by the
    sampler's pixel sample, through the lens point u_lens [n, 2] (each
    caller passes the reference's draw: eye_lens_draw, or vpl's
    lens_sample)."""
    jitter = sen.sampler.pixel_sample(lane_px, sidx, sen.sampler.sample_count)
    x = (lane_px % w).to(torch.float32) + jitter[..., 0]
    y = (lane_px // w).to(torch.float32) + jitter[..., 1]
    pos01 = torch.stack([x / w, y / h], dim=-1)
    return generate_rays(cam, pos01, u_lens)


def make_sppm_passes(pack, integ, sen, w, h, seed, device):
    """The two passes of an iteration (reference make_sppm_passes):

      eye_fn(lane_px, it) -> (L [n, 3], visible points: (valid, p, ns, wi,
          beta, mat, uv))
      photon_fn(lane_ph, it, vps, r2) -> (M [n], tau [n, 3], overflow:
          the mean share of windows past PHOTONS_PER_CELL, summed over the
          8 cells)

    and the scene's extent.  Each pass adds the rays it traced (an int64
    tensor) to stats["rays"] and photon_fn the photons it stored to
    stats["photons"]."""
    present = pack.meta["present_types"]
    max_depth = max_depth_of(integ)
    lo, hi, extent = _scene_grid_bounds(pack)
    cam = sen.pack(w, h, device)
    seed_ph = rng.stream_seed(seed, rng.STREAM_LIGHT)
    origin = torch.tensor(lo, dtype=torch.float32, device=device)
    span = torch.tensor(hi - lo, dtype=torch.float32, device=device)
    stats = {"rays": torch.zeros((), dtype=torch.int64, device=device), "photons": 0}

    def eye_pass(lane_px, it):
        n = lane_px.shape[0]
        with torch.profiler.record_function("stage:eye"):
            sidx = torch.full_like(lane_px, it)
            o, d = camera_rays(sen, cam, w, h, lane_px, sidx,
                               eye_lens_draw(sen.sampler, lane_px, sidx))
            z3 = torch.zeros(n, 3, dtype=torch.float32, device=device)
            L, thr = z3, torch.ones_like(z3)
            active = torch.ones(n, dtype=torch.bool, device=device)
            vp_valid = torch.zeros_like(active)
            vp_p, vp_ns, vp_wi, vp_beta = z3, z3, z3, z3
            vp_mat = torch.zeros(n, dtype=torch.int32, device=device)
            vp_uv = torch.zeros(n, 2, dtype=torch.float32, device=device)
            prev_delta = torch.ones_like(active)
            prev_pdf = torch.ones(n, dtype=torch.float32, device=device)
            outs = [torch.zeros_like(x) for x in (L, vp_valid, vp_p, vp_ns, vp_wi, vp_beta,
                                                  vp_mat, vp_uv)]
            live = LiveLanes(n, device)
            for depth in range(max_depth):
                if depth % lanes.EXIT_CHECK_EVERY == 0:
                    live.write(outs, (L, vp_valid, vp_p, vp_ns, vp_wi, vp_beta, vp_mat, vp_uv))
                    sub = live.narrow(active, L, vp_valid, vp_p, vp_ns, vp_wi, vp_beta, vp_mat,
                                      vp_uv, thr, active, o, d, prev_delta, prev_pdf, lane_px,
                                      sidx)
                    if sub is None:
                        break
                    (L, vp_valid, vp_p, vp_ns, vp_wi, vp_beta, vp_mat, vp_uv, thr, active, o, d,
                     prev_delta, prev_pdf, lane_px, sidx) = sub
                stats["rays"] = stats["rays"] + active.sum()
                hit = intersect(pack, o, d)
                its = fill_interaction(pack, o, d, hit)
                # environment and emitter hits, MIS against the delta
                # chain's BSDF draws (as the path tracer)
                L = _path.emitted(pack, d, its, active, thr, L, prev_pdf, prev_delta)
                active = active & its.valid
                sp = shading_params(pack, its.mat, its.uv, its=its)
                frame = shading_frame(pack, its)
                wi_l = frame.to_local(its.wi_world)
                delta = is_delta(sp)

                # the visible point: the first non-delta surface
                store = active & ~delta & ~vp_valid
                s3 = store[..., None]
                vp_valid = vp_valid | store
                vp_p = torch.where(s3, its.p, vp_p)
                vp_ns = torch.where(s3, its.ns, vp_ns)
                vp_wi = torch.where(s3, its.wi_world, vp_wi)
                vp_beta = torch.where(s3, thr, vp_beta)
                vp_mat = torch.where(store, its.mat, vp_mat)
                vp_uv = torch.where(s3, its.uv, vp_uv)

                # one NEE sample at the visible point, weight 1: the eye
                # path stops there and the photons carry indirect light
                if pack.meta["n_emitters"] > 0:
                    u_n = rng.rand4(lane_px, sidx, depth * _EYE_SLOTS + 1, seed)
                    ds = em.sample_direct(pack, its.p, u_n[..., :3])
                    f = bsdf_eval(sp, wi_l, frame.to_local(ds.d), present)
                    o_sh = _path._offset_ray(its.p, its.ng, ds.d)
                    sh_t = torch.where(ds.dist >= em.ENV_DIST, 1e7, ds.dist * (1.0 - SHADOW_EPS))
                    # the other lanes (whose p may be inf past an escape)
                    # trace an empty segment, whose result they do not read
                    occ = occluded(pack, *empty_segments(pack, store, o_sh, ds.d, sh_t))
                    stats["rays"] = stats["rays"] + store.sum()
                    L = L + torch.where((store & ~occ)[..., None], thr * ds.value * f, 0.0)

                # delta lanes walk on; stored lanes stop
                active = active & delta & ~vp_valid
                u_b = rng.rand4(lane_px, sidx, depth * _EYE_SLOTS + 2, seed)
                bs = bsdf_sample(sp, wi_l, u_b[..., :2], u_b[..., 2], present)
                a3 = active[..., None]
                thr = thr * torch.where(a3, bs.weight, 1.0)
                d_new = frame.to_world(bs.wo)
                o = torch.where(a3, _path._offset_ray(its.p, its.ng, d_new), o)
                d = torch.where(a3, d_new, d)
                prev_pdf = torch.where(active, bs.pdf, prev_pdf)
                prev_delta = torch.where(active, bs.delta, prev_delta)
                active = active & (thr.amax(dim=-1) > 0)
            else:
                live.write(outs, (L, vp_valid, vp_p, vp_ns, vp_wi, vp_beta, vp_mat, vp_uv))
        return outs[0], tuple(outs[1:])

    def photon_walk(lane_ph, it):
        """The photons of one pass, live only: (g, p, d, power), g their
        index in the reference's depth-major slot list, ascending."""
        n_ph = lane_ph.shape[0]
        sidx = torch.full_like(lane_ph, it)
        p0, n0, d0, beta, _, _ = _sample_emitter_ray(pack, lane_ph, sidx, seed)
        o, d = p0 + n0 * 1e-4, d0
        active = beta.amax(dim=-1) > 0
        lane = lane_ph
        live = LiveLanes(n_ph, device)
        got = []
        for depth in range(max_depth):
            if depth % lanes.EXIT_CHECK_EVERY == 0:
                sub = live.narrow(active, o, d, beta, active, lane, sidx)
                if sub is None:
                    break
                o, d, beta, active, lane, sidx = sub
            stats["rays"] = stats["rays"] + active.sum()
            hit = intersect(pack, o, d)
            its = fill_interaction(pack, o, d, hit)
            active = active & its.valid
            if depth >= 1:  # depth-0 hits carry direct light (the eye NEE's)
                got.append((depth * n_ph + live.ids, its.p, d, beta, active))
            sp = shading_params(pack, its.mat, its.uv, its=its)
            frame = shading_frame(pack, its)
            wi_l = frame.to_local(its.wi_world)
            u_b = rng.rand4(lane, sidx, depth * _PH_SLOTS + 2, seed_ph)
            bs = bsdf_sample(sp, wi_l, u_b[..., :2], u_b[..., 2], present)
            beta = beta * torch.where(active[..., None], bs.weight, 0.0)
            d = frame.to_world(bs.wo)
            o = _path._offset_ray(its.p, its.ng, d)
            if depth >= 3:  # RR keeps the walk bounded in energy
                u_r = rng.rand4(lane, sidx, depth * _PH_SLOTS + 3, seed_ph)[..., 0]
                q = torch.clamp(beta.amax(dim=-1), 0.05, 0.95)
                keep = u_r < q
                beta = torch.where(keep[..., None], beta / q[..., None], 0.0)
                active = active & keep
            active = active & (beta.amax(dim=-1) > 0)
        if not got:
            e = torch.zeros(0, 3, dtype=torch.float32, device=device)
            return torch.zeros(0, dtype=torch.int64, device=device), e, e, e
        g, p, dd, pw, ok = (torch.cat(x) for x in zip(*got))
        keep = torch.nonzero(ok).squeeze(1)
        return g[keep], p[keep], dd[keep], pw[keep]

    def photon_pass(lane_ph, it, vps, r2):
        vp_valid, vp_p, vp_ns, vp_wi, vp_beta, vp_mat, vp_uv = vps
        n_vp = vp_p.shape[0]
        r_max = torch.sqrt(torch.where(vp_valid, r2, 0.0).amax())
        cell = 2.0 * torch.clamp(r_max, min=1e-6)
        inv_cell = 1.0 / cell
        # clamped so that the cell ids stay small as the radii shrink
        dims = torch.clamp(torch.ceil(span * inv_cell), 1, 1024).to(torch.int64)

        with torch.profiler.record_function("stage:photon_walk"):
            g, ph_p, ph_d, ph_pow = photon_walk(lane_ph, it)
        stats["photons"] += g.shape[0]
        with torch.profiler.record_function("stage:sort"):
            cid = _cell_id(_grid_cell(ph_p, origin, inv_cell, dims), dims)
            order, cid_s = cell_order(cid, g)
            ph_p, ph_d, ph_pow = ph_p[order], ph_d[order], ph_pow[order]

        with torch.profiler.record_function("stage:gather"):
            vq0 = torch.floor((vp_p - origin) * inv_cell - 0.5).to(torch.int64)
            frame_v = mm.Frame.from_normal(vp_ns)
            zeros = torch.zeros(n_vp, 3, dtype=torch.float32, device=device)
            return gather_windows(pack, (cid_s, ph_p, ph_d, ph_pow), PHOTONS_PER_CELL, vp_p,
                                  vp_valid, vq0, dims, r2, shading_params(pack, vp_mat, vp_uv),
                                  frame_v, frame_v.to_local(vp_wi), vp_beta, zeros[:, 0], zeros)

    eye_pass.stats = photon_pass.stats = stats
    return eye_pass, photon_pass, extent


def gather_windows(pack, photon_map, k_max, p, read, vq0, dims, r2, sp, frame, wi_l, beta, M,
                   tau):
    """The photon gather at the points p of the lanes `read`: the first
    k_max photons of each cell of the 2x2x2 neighbourhood whose lowest
    corner is the cell vq0 (sum order: the cells in NEIGHBOURS order, then
    k = 0, 1, ...), those within sqrt(r2) adding beta f(wi, -d) power /
    |cos| scaled by the cell's count / k_max, and count / k_max to M.
    The bounded scan is an unbiased subsample of the cell: the shuffle
    makes a photon's place in its cell independent of its depth and flux.
    photon_map: (sorted cell ids, positions, directions, powers).  Returns
    (M, tau, the mean share of windows past k_max summed over the 8
    cells)."""
    present = pack.meta["present_types"]
    cid_s, ph_p, ph_d, ph_pow = photon_map
    P = cid_s.shape[0]
    overflow = torch.zeros((), dtype=torch.float32, device=p.device)
    for off in NEIGHBOURS:
        qn = vq0 + torch.tensor(off, dtype=torch.int64, device=p.device)
        ok_cell = read & ((qn >= 0) & (qn < dims)).all(dim=-1)
        start, count = window(cid_s, _cell_id(torch.clamp(qn, min=0), dims))
        scale = torch.clamp(count.to(torch.float32) / k_max, min=1.0)
        overflow = overflow + (count > k_max).to(torch.float32).mean()
        # windows past the longest one a lane reads add zero
        n_k = min(k_max, int(torch.where(ok_cell, count, 0).amax())) if P else 0
        for k in range(n_k):
            idx = torch.clamp(start + k, max=P - 1)
            pp, dd, pw = ph_p[idx], ph_d[idx], ph_pow[idx]
            inside = ok_cell & (k < count) & (((pp - p) ** 2).sum(dim=-1) <= r2)
            # the photon arrives along dd: bsdf_eval's |cos| divided back out
            wo_l = frame.to_local(-dd)
            f = bsdf_eval(sp, wi_l, wo_l, present)
            cos_o = torch.clamp(torch.abs(mm.cos_theta(wo_l)), min=1e-6)
            contrib = beta * f / cos_o[..., None] * pw * scale[..., None]
            tau = tau + torch.where(inside[..., None], contrib, 0.0)
            M = M + torch.where(inside, scale, 0.0)
    return M, tau, overflow


def progress(N, tau, r2, M, tau_i):
    """The SPPM radius and flux update (Hachisuka and Jensen 2009, eq.
    8-10): (N, tau, r2) after an iteration's M and tau_i."""
    M = torch.clamp(M, min=0.0)
    grow = N + ALPHA * M
    denom = torch.clamp(N + M, min=1e-6)
    ratio = torch.where(M > 0, grow / denom, 1.0)
    return grow, (tau + tau_i) * ratio[..., None], r2 * ratio


def radiance(L_direct, n_iters, tau, r2, total_photons):
    """tau / (N_emitted pi r^2) plus the mean direct light."""
    indirect = tau / (torch.clamp(r2, min=1e-12)[..., None] * (np.pi * total_photons))
    return L_direct / n_iters + indirect


def photons_per_pass_of(photons_per_pass, default):
    """An explicit count wins over MTS_SPPM_PHOTONS."""
    return photons_per_pass or int(os.environ.get("MTS_SPPM_PHOTONS", default))


def initial_radius(extent, w, h):
    return float(os.environ.get("MTS_SPPM_R0", extent / max(w, h) * 2.0))


def iter_sppm(scene, pack, spp=None, seed=0, photons_per_pass=None, device="cuda", timed=False):
    """SPPM iteration by iteration on `device`: yields (image [H, W, 3]
    tensor, iterations done, stats) after each iteration; stats holds the
    rays traced (an int64 tensor), the photons stored, the overflow (the
    windows past PHOTONS_PER_CELL, summed over the 8 cells, per visible
    point and iteration) and, with `timed`, the seconds of each eye and
    photon pass (host clock around each pass, ended by a synchronise)."""
    import time

    device = torch.device(device)
    sen = scene.sensor.record
    w, h = sen.film.width, sen.film.height
    n_px = w * h
    n_iters = spp or sen.sampler.sample_count
    n_photons = photons_per_pass_of(photons_per_pass, 1 << 18)
    eye_pass, photon_pass, extent = make_sppm_passes(pack, scene.integrator, sen, w, h, seed,
                                                     device)
    r0 = initial_radius(extent, w, h)
    lane_px = torch.arange(n_px, dtype=torch.int64, device=device)
    lane_ph = torch.arange(n_photons, dtype=torch.int64, device=device)
    r2 = torch.full((n_px,), r0 * r0, dtype=torch.float32, device=device)
    N = torch.zeros(n_px, dtype=torch.float32, device=device)
    tau = torch.zeros(n_px, 3, dtype=torch.float32, device=device)
    L_direct = torch.zeros(n_px, 3, dtype=torch.float32, device=device)
    stats = eye_pass.stats
    stats.update(overflow=0.0, eye_s=[], photon_s=[])

    def clock():
        if timed:
            if device.type == "cuda":
                torch.cuda.synchronize()
            return time.time()
        return 0.0

    for it in range(n_iters):
        t0 = clock()
        L_i, vps = eye_pass(lane_px, it)
        L_direct = L_direct + L_i
        t1 = clock()
        M, tau_i, dropped = photon_pass(lane_ph, it, vps, r2)
        stats["overflow"] += float(dropped)
        t2 = clock()
        if timed:
            stats["eye_s"].append(t1 - t0)
            stats["photon_s"].append(t2 - t1)
        N, tau, r2 = progress(N, tau, r2, M, tau_i)
        yield (radiance(L_direct, it + 1, tau, r2, (it + 1) * n_photons).reshape(h, w, 3),
               it + 1, stats)
    if stats["overflow"] > 0.05 * n_iters:
        print(f"[sppm] per-cell scan window often overflowed "
              f"({stats['overflow'] / n_iters:.2f} mean cells/px/pass); gather used unbiased "
              f"count/K subsampling — variance is elevated")


def render_sppm(scene, spp=None, seed=0, pack=None, photons_per_pass=None, device="cuda"):
    """Progressive render on `device`: `spp` SPPM iterations, each one eye
    pass of one sample per pixel and one photon pass of photons_per_pass
    photons (MTS_SPPM_PHOTONS, 2^18 by default).  Returns numpy [H, W, 3];
    the last iteration's stats are left in render_sppm.last_stats."""
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device)
    if pack is None:
        pack = pack_scene(scene, device)
    sen = scene.sensor.record
    if pack.meta["n_emitters"] == 0:
        return np.zeros((sen.film.height, sen.film.width, 3), np.float32)
    img, stats = None, None
    for img, _, stats in iter_sppm(scene, pack, spp, seed, photons_per_pass, device):
        pass
    render_sppm.last_stats = stats
    return img.cpu().numpy()


render_sppm.last_stats = None
