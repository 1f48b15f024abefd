"""Virtual point lights / instant radiosity (port of
mitsuba_tpu/integrator/vpl.py; reference src/librender/vpl.cpp:76 and
src/integrators/vpl/vpl.cpp).

Each pass walks n_vpl light paths, which leave a VPL at the emitter
sample and at every surface vertex (`_generate_vpls`); then one camera
ray per pixel walks through delta surfaces to its first connectible
point, and every VPL lights it with a clamped geometry term:

    emitter VPL:  f_cam * Le (A / pmf) cos_l / max(d^2, b^2) / n_vpl
    surface VPL:  f_cam * f_vpl(wi_vpl -> x) beta / max(d^2, b^2) / n_vpl

(bsdf_eval folds both cosines), b = 0.1 scene radius (the reference's
relative clamping).  The reference's loop over the VPLs becomes a host
loop of one shadow batch per live VPL (a dead VPL adds zero).  The
decision uniforms are `rand4(pixel, pass, depth * 4 + 2)` in the eye walk
and the light stream's `rand4(vpl, pass, depth * 4 + 2)` in the light
walks, as in the reference.
"""

from __future__ import annotations

import os

import torch

from mitsuba_tpu_torch.accel.intersect import (
    empty_segments,
    fill_interaction,
    intersect,
    occluded,
)
from mitsuba_tpu_torch.bsdf.eval import bsdf_eval, bsdf_sample
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.gather import take_rows
from mitsuba_tpu_torch.emitter import eval as em
from mitsuba_tpu_torch.integrator import path as _path
from mitsuba_tpu_torch.integrator import sppm as _sppm
from mitsuba_tpu_torch.integrator.ptracer import _sample_emitter_ray
from mitsuba_tpu_torch.scene.texture_eval import mip_footprint, shading_frame, shading_params

_SLOTS = 4
EYE_DEPTH = 4  # delta bounces the eye walk follows to a connectible point
CLAMPING = 0.1  # the geometry term's clamp, in scene radii


def _generate_vpls(pack, n_vpl, vpl_depth, pass_i, seed, present, device):
    """Light random walks -> the VPLs (= generateVPLs, vpl.cpp:76): a dict
    of [n_vpl * (vpl_depth + 1)] tensors, emitter samples first, then each
    depth's vertices: kind (0 area emitter, 2 other emitter, 1 surface,
    -1 none), p, n, wi (surface), w [., 3], mat, uv."""
    lane = torch.arange(n_vpl, dtype=torch.int64, device=device)
    sidx = torch.full_like(lane, pass_i)
    seed_l = rng.stream_seed(seed, rng.STREAM_LIGHT)
    p0, n0, d0, beta, is_area, e0 = _sample_emitter_ray(pack, lane, sidx, seed)

    le = take_rows(pack.em_rgb, e0)
    pmf = torch.clamp(pack.emitter_pmf[e0], min=1e-12)
    w_emit = le * (pack.em_area[e0] / pmf)[..., None]
    w_point = le / pmf[..., None]  # intensity / pmf: no cosine, no area

    kinds = [torch.where(is_area, 0, 2).to(torch.int32)]
    ps, ns, wis = [p0], [n0], [d0]
    ws = [torch.where(is_area[..., None], w_emit, w_point)]
    mats = [torch.zeros(n_vpl, dtype=torch.int32, device=device)]
    uvs = [torch.zeros(n_vpl, 2, dtype=torch.float32, device=device)]

    o, d = p0 + n0 * 1e-4, d0
    active = beta.amax(dim=-1) > 0
    for depth in range(vpl_depth):
        hit = intersect(pack, o, d)
        its = fill_interaction(pack, o, d, hit)
        active = active & its.valid
        frame = shading_frame(pack, its)
        wi_l = frame.to_local(its.wi_world)
        sp = shading_params(pack, its.mat, its.uv, its=its)

        kinds.append(torch.where(active, 1, -1).to(torch.int32))
        ps.append(its.p)
        ns.append(its.ns)
        wis.append(its.wi_world)
        ws.append(torch.where(active[..., None], beta, 0.0))
        mats.append(its.mat)
        uvs.append(its.uv)

        u_b = rng.rand4(lane, sidx, depth * _SLOTS + 2, seed_l)
        bs = bsdf_sample(sp, wi_l, u_b[..., :2], u_b[..., 2], present)
        beta = beta * torch.where(active[..., None], bs.weight, 0.0)
        d = frame.to_world(bs.wo)
        o = _path._offset_ray(its.p, its.ng, d)
        active = active & (beta.amax(dim=-1) > 0)

    return dict(kind=torch.cat(kinds), p=torch.cat(ps), n=torch.cat(ns), wi=torch.cat(wis),
                w=torch.cat(ws), mat=torch.cat(mats), uv=torch.cat(uvs))


def vpl_count():
    return int(os.environ.get("MTS_VPL_COUNT", 64))


def make_vpl_pass(pack, integ, sen, w, h, seed, device):
    """One VPL pass fn(film, pass_i) -> film + this pass's image [H, W, 3].
    Passes are independent (pass_i keys the RNG).  fn.stats holds the rays
    traced (an int64 tensor) and the live VPLs lit so far."""
    n_px = w * h
    present = pack.meta["present_types"]
    n_vpl = vpl_count()
    vpl_depth = max(min((integ.max_depth - 2) if integ.max_depth > 0 else 3, 6), 0)
    b2 = (CLAMPING * pack.meta["scene_radius"]) ** 2
    cam = sen.pack(w, h, device)
    lane_px = torch.arange(n_px, dtype=torch.int64, device=device)
    stats = {"rays": torch.zeros((), dtype=torch.int64, device=device), "vpls": 0}

    def eye_walk(pass_i):
        """The connectible points: (L, ok, p, ns, ng, wi, mat, uv, thr)."""
        sidx = torch.full_like(lane_px, pass_i)
        o, d = _sppm.camera_rays(sen, cam, w, h, lane_px, sidx,
                                 sen.sampler.lens_sample(lane_px, sidx))
        z3 = torch.zeros(n_px, 3, dtype=torch.float32, device=device)
        L, thr = z3, torch.ones_like(z3)
        active = torch.ones(n_px, dtype=torch.bool, device=device)
        vp_ok = torch.zeros_like(active)
        done_p, done_ns, done_ng, done_wi, done_thr = z3, z3, z3, z3, z3
        done_mat = torch.zeros(n_px, dtype=torch.int32, device=device)
        done_uv = torch.zeros(n_px, 2, dtype=torch.float32, device=device)
        for depth in range(EYE_DEPTH):
            stats["rays"] = stats["rays"] + active.sum()
            hit = intersect(pack, o, d)
            its = fill_interaction(pack, o, d, hit)
            found = active & its.valid
            if pack.meta.get("has_env", False):
                esc = active & ~its.valid
                L = L + torch.where(esc[..., None], thr * em.eval_env(pack, d), 0.0)
            cos_l = mm.dot(its.ns, its.wi_world)
            emis = found & (its.emit >= 0) & (cos_l > 0)
            le = take_rows(pack.em_rgb, torch.clamp(its.emit, min=0))
            L = L + torch.where(emis[..., None], thr * le, 0.0)

            active = found
            sp = shading_params(pack, its.mat, its.uv, mip_footprint(pack, its), its=its)
            delta = _sppm.is_delta(sp)
            store = active & ~delta & ~vp_ok
            s3 = store[..., None]
            vp_ok = vp_ok | store
            done_p = torch.where(s3, its.p, done_p)
            done_ns = torch.where(s3, its.ns, done_ns)
            done_ng = torch.where(s3, its.ng, done_ng)
            done_wi = torch.where(s3, its.wi_world, done_wi)
            done_mat = torch.where(store, its.mat, done_mat)
            done_uv = torch.where(s3, its.uv, done_uv)
            done_thr = torch.where(s3, thr, done_thr)

            active = active & delta & ~vp_ok
            frame = shading_frame(pack, its)
            wi_l = frame.to_local(its.wi_world)
            u_b = rng.rand4(lane_px, sidx, depth * _SLOTS + 2, seed)
            bs = bsdf_sample(sp, wi_l, u_b[..., :2], u_b[..., 2], present)
            a3 = active[..., None]
            thr = thr * torch.where(a3, bs.weight, 1.0)
            d_new = frame.to_world(bs.wo)
            o = torch.where(a3, _path._offset_ray(its.p, its.ng, d_new), o)
            d = torch.where(a3, d_new, d)
            active = active & (thr.amax(dim=-1) > 0)
        return L, vp_ok, done_p, done_ns, done_ng, done_wi, done_mat, done_uv, done_thr

    def one_pass(film, pass_i):
        with torch.profiler.record_function("stage:photon_walk"):
            vpls = _generate_vpls(pack, n_vpl, vpl_depth, pass_i, seed, present, device)
        with torch.profiler.record_function("stage:eye"):
            L, vp_ok, done_p, done_ns, done_ng, done_wi, done_mat, done_uv, done_thr = \
                eye_walk(pass_i)
            sp_v = shading_params(pack, done_mat, done_uv)
            frame_v = mm.Frame.from_normal(done_ns)
            wi_lv = frame_v.to_local(done_wi)

        # the VPLs' shading, once per VPL
        sp_l = shading_params(pack, vpls["mat"], vpls["uv"])
        fr_l = mm.Frame.from_normal(vpls["n"])
        wi_ll = fr_l.to_local(vpls["wi"])
        L_vpl = torch.zeros(n_px, 3, dtype=torch.float32, device=device)
        kinds = vpls["kind"].tolist()
        with torch.profiler.record_function("stage:vpl_shadow"):
            for j, kind_j in enumerate(kinds):
                if kind_j < 0:  # no vertex: adds zero
                    continue
                stats["vpls"] += 1
                to_l = vpls["p"][j][None, :] - done_p
                d2 = (to_l * to_l).sum(dim=-1)
                dist = torch.sqrt(torch.clamp(d2, min=1e-12))
                dir_l = to_l / dist[..., None]
                f_cam = bsdf_eval(sp_v, wi_lv, frame_v.to_local(dir_l), present)
                if kind_j == 1:  # a surface VPL: its bsdf toward the eye point
                    # (the static keys of the shading dict stay as they are)
                    spj = {k: v[j].expand(n_px, *v.shape[1:]) if torch.is_tensor(v) else v
                           for k, v in sp_l.items()}
                    frame_j = mm.Frame(fr_l.s[j].expand(n_px, 3), fr_l.t[j].expand(n_px, 3),
                                       fr_l.n[j].expand(n_px, 3))
                    e_j = bsdf_eval(spj, wi_ll[j].expand(n_px, 3), frame_j.to_local(-dir_l),
                                    present)
                elif kind_j == 0:  # an area emitter: one-sided cosine emission
                    e_j = torch.clamp(mm.dot(-dir_l, vpls["n"][j][None, :]), min=0.0)[..., None]
                else:  # a point light: isotropic
                    e_j = torch.ones(n_px, 1, dtype=torch.float32, device=device)
                geo = 1.0 / torch.clamp(d2, min=b2)  # relative clamping
                contrib = done_thr * f_cam * e_j * vpls["w"][j][None, :] * geo[..., None]
                ok = vp_ok & (contrib.amax(dim=-1) > 0)
                o_sh = _path._offset_ray(done_p, done_ng, dir_l)
                # the lanes without a contribution trace an empty segment
                occ = occluded(pack, *empty_segments(pack, ok, o_sh, dir_l,
                                                     dist * (1.0 - 1e-3)))
                stats["rays"] = stats["rays"] + ok.sum()
                L_vpl = L_vpl + torch.where((ok & ~occ)[..., None], contrib, 0.0)
        L = L + L_vpl / n_vpl
        return film + L.reshape(h, w, 3)

    one_pass.stats = stats
    return one_pass


def iter_vpl(scene, pack, spp=None, seed=0, device="cuda"):
    """VPL passes on `device`: yields (image [H, W, 3] tensor, passes
    done, stats) after each pass, each with a fresh VPL set."""
    device = torch.device(device)
    sen = scene.sensor.record
    w, h = sen.film.width, sen.film.height
    spp = spp or sen.sampler.sample_count
    one_pass = make_vpl_pass(pack, scene.integrator, sen, w, h, seed, device)
    film = torch.zeros(h, w, 3, dtype=torch.float32, device=device)
    for i in range(spp):
        film = one_pass(film, i)
        yield film / (i + 1), i + 1, one_pass.stats


def render_vpl(scene, spp=None, seed=0, pack=None, device="cuda"):
    """Instant-radiosity render on `device`: `spp` passes of
    MTS_VPL_COUNT (64) light paths each, averaged.  Returns numpy
    [H, W, 3]; the stats are left in render_vpl.last_stats."""
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device)
    if pack is None:
        pack = pack_scene(scene, device)
    img, stats = None, None
    for img, _, stats in iter_vpl(scene, pack, spp, seed, device):
        pass
    render_vpl.last_stats = stats
    return img.cpu().numpy()


render_vpl.last_stats = None
