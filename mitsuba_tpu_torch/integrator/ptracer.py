"""Adjoint particle tracer (port of mitsuba_tpu/integrator/ptracer.py,
reference src/integrators/ptracer/{ptracer.cpp, ptracer_proc.cpp} and
src/librender/particleproc.cpp): particles start on the emitters, walk
the scene, and every vertex is connected to the pinhole camera.

A pixel's value is its mean radiance, so the importance over camera
directions is
    K(w) = (W * H * aspect) / (4 tan(fx/2)^2 cos^3(theta_c))
inside the frustum, and a surface vertex p with particle throughput beta
adds
    beta * f(wi -> cam) * V(p, cam) * K / dist^2 / N_particles
to the pixel it projects into (the nearest pixel, no reconstruction
filter, as in the reference).  On the card those adds land in any order
(`index_put_` with accumulate), so the film may differ from run to run
in the last places.

The reference's `lax.while_loop` becomes a host loop over the particles
still alive (core/lanes.py).  The counter RNG draws the reference's
numbers: the light stream, slot depth * 4 + 2 for the BSDF, + 3 for the
roulette.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mitsuba_tpu_torch.accel.intersect import (
    empty_segments,
    fill_interaction,
    intersect,
    occluded,
)
from mitsuba_tpu_torch.bsdf.eval import bsdf_eval, bsdf_sample
from mitsuba_tpu_torch.core import lanes, rng, warp
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.lanes import LiveLanes
from mitsuba_tpu_torch.emitter.eval import _searchsorted_segment, spot_falloff
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
from mitsuba_tpu_torch.scene.texture_eval import shading_frame, shading_params

_SLOTS = 4
BATCH_MAX = 1 << 20  # particles per batch (reference ptracer.py:381)


def pick_emitter(pack, u):
    """Emitter ids from the scene's pmf: the reference's
    searchsorted(side="right") - 1, clipped into the table."""
    e = torch.searchsorted(pack.emitter_cdf, u.contiguous(), right=True) - 1
    return torch.clamp(e, 0, pack.emitter_pmf.shape[0] - 1)


def _sample_emitter_ray(pack, lane, sidx, seed):
    """(position, normal, direction, throughput beta, is_area, emitter id)
    of each particle's emission, for every emitter kind (reference
    AbstractEmitter::samplePosition / sampleDirection and each emitter's
    sampleRay: area cosine, point uniform sphere, spot uniform cone times
    the falloff, collimated delta / delta, directional, constant and
    envmap from a disk at the scene's bounding sphere)."""
    r = lane.shape[0]
    dev = lane.device
    kinds = pack.meta.get("emitter_kinds", ())
    seed = rng.stream_seed(seed, rng.STREAM_LIGHT)
    u = rng.rand4(lane, sidx, 0, seed)
    u2 = rng.rand4(lane, sidx, 1, seed)
    e = pick_emitter(pack, u[..., 0])
    pmf = pack.emitter_pmf[e]
    kind = pack.em_kind[e]
    rgb = pack.em_rgb[e]

    zeros3 = torch.zeros(r, 3, dtype=torch.float32, device=dev)
    p, n, d, beta = zeros3, zeros3, zeros3, zeros3

    def put(sel, p_t, n_t, d_t, b_t):
        nonlocal p, n, d, beta
        s3 = sel[..., None]
        p = torch.where(s3, p_t, p)
        n = torch.where(s3, n_t, n)
        d = torch.where(s3, d_t, d)
        beta = torch.where(s3, b_t, beta)

    if pack.meta["has_area"]:
        # a non-area lane's empty segment [0, 0) reads slot 0
        tri_slot = _searchsorted_segment(
            pack.area_tri_cdf, u[..., 1], pack.em_tri_lo[e], pack.em_tri_hi[e]
        )
        tri = pack.area_tri_idx[tri_slot]
        bary = warp.square_to_uniform_triangle(u[..., 2:4])
        e1, e2 = pack.tri_e1[tri], pack.tri_e2[tri]
        p_a = pack.tri_v0[tri] + bary[..., 0:1] * e1 + bary[..., 1:2] * e2
        n_a = mm.normalize(mm.cross(e1, e2))
        d_a = mm.Frame.from_normal(n_a).to_world(warp.square_to_cosine_hemisphere(u2[..., 0:2]))
        # Le * cos / (pdf_pos * pdf_dir * pmf) = Le * pi * area / pmf
        area = pack.em_area[e]
        put(kind == AREA, p_a, n_a, d_a,
            rgb * (math.pi * area / torch.clamp(pmf, min=1e-12))[..., None])

    inv_pmf = 1.0 / torch.clamp(pmf, min=1e-12)
    if not kinds or POINT in kinds:
        d_p = warp.square_to_uniform_sphere(u2[..., 0:2])
        put(kind == POINT, pack.em_pos[e], d_p, d_p, rgb * (4.0 * math.pi * inv_pmf)[..., None])
    if SPOT in kinds:
        axis = pack.em_dir[e]
        cc = pack.em_cos_cutoff[e]
        cb = pack.em_cos_beam[e]
        d_s = mm.Frame.from_normal(axis).to_world(
            warp.square_to_uniform_cone(u2[..., 0:2], cc)
        )
        fall = spot_falloff(mm.dot(d_s, axis), cc, cb)
        pdf_cone = warp.square_to_uniform_cone_pdf(cc)
        put(kind == SPOT, pack.em_pos[e], d_s, d_s,
            rgb * (fall / torch.clamp(pdf_cone, min=1e-12) * inv_pmf)[..., None])
    if COLLIMATED in kinds:
        d_b = pack.em_dir[e]
        put(kind == COLLIMATED, pack.em_pos[e], d_b, d_b, rgb * inv_pmf[..., None])

    # infinite and directional lights launch from a disk of the scene's
    # bounding sphere, perpendicular to the emission (pdf_pos 1/(pi R^2))
    center = torch.tensor(pack.meta["scene_center"], dtype=torch.float32, device=dev)
    radius = pack.meta["scene_radius"]
    radius_f = torch.tensor(radius, dtype=torch.float32, device=dev)

    def disk_origin(d_emit, uv):
        xy = warp.square_to_uniform_disk(uv) * radius_f
        offs = mm.Frame.from_normal(d_emit).to_world(
            torch.stack([xy[..., 0], xy[..., 1], torch.zeros_like(xy[..., 0])], dim=-1)
        )
        return center[None, :] - d_emit * (1.1 * radius_f) + offs

    disk_area = math.pi * radius_f * radius_f
    if DIRECTIONAL in kinds:
        d_dir = pack.em_dir[e]
        put(kind == DIRECTIONAL, disk_origin(d_dir, u[..., 1:3]), d_dir, d_dir,
            rgb * (disk_area * inv_pmf)[..., None])
    if CONSTANT in kinds:
        d_c = warp.square_to_uniform_sphere(u2[..., 0:2])
        put(kind == CONSTANT, disk_origin(d_c, u[..., 1:3]), d_c, d_c,
            rgb * (4.0 * math.pi * disk_area * inv_pmf)[..., None])
    if pack.meta.get("has_envmap", False):
        from mitsuba_tpu_torch.emitter.eval import (
            _env_bilinear,
            _env_uv_from_dir,
            _sample_env_dir,
        )

        d_to_env, pdf_env = _sample_env_dir(pack, u2)
        le = _env_bilinear(pack, _env_uv_from_dir(pack, d_to_env))
        d_e = -d_to_env  # photons travel into the scene
        put(kind == ENVMAP, disk_origin(d_e, u[..., 1:3]), d_e, d_e,
            le * (disk_area / torch.clamp(pdf_env, min=1e-12) * inv_pmf)[..., None])
    return p, n, d, beta, kind == AREA, e


def camera_info(sen, w, h, device):
    """The pinhole camera's (position, world-to-camera matrix, tan of the
    half x field of view, aspect, W, H, forward axis)."""
    th = math.tan(math.radians(sen.xfov_deg) / 2.0)
    tw = np.asarray(sen.to_world.m, np.float32)
    cam_pos = torch.tensor(tw[:3, 3], device=device)
    world_to_cam = torch.tensor(np.asarray(sen.to_world.inv, np.float32), device=device)
    cam_fwd = torch.tensor(tw[:3, 2], device=device)  # camera +z in world space
    return cam_pos, world_to_cam, th, w / h, w, h, cam_fwd


def project(cam_info, p):
    """Film coordinates (sx, sy) in [0, 1)^2 of world points p, and
    whether p lies inside the frustum."""
    _, world_to_cam, th, aspect, _, _, _ = cam_info
    v = p @ world_to_cam[:3, :3].T + world_to_cam[:3, 3]
    behind = v[..., 2] <= 1e-6
    x_cam = v[..., 0] / torch.clamp(v[..., 2], min=1e-6)
    y_cam = v[..., 1] / torch.clamp(v[..., 2], min=1e-6)
    sx = 0.5 * (1.0 - x_cam / th)
    sy = 0.5 * (1.0 - y_cam * aspect / th)
    inside = (sx >= 0.0) & (sx < 1.0) & (sy >= 0.0) & (sy < 1.0) & ~behind
    return sx, sy, inside


def camera_importance(cam_info, d_c):
    """K(w) of directions d_c from the camera (the per-pixel-sample
    solid-angle density of a pinhole camera)."""
    _, _, th, aspect, w, h, cam_fwd = cam_info
    cos_c = torch.abs(mm.dot(d_c, cam_fwd))
    return (w * h * aspect) / (4.0 * th * th * torch.clamp(cos_c, min=1e-6) ** 3)


def _connect_to_camera(pack, cam_info, p, value_rgb, film, active):
    """Add value * K * V / dist^2 to the film at p's projection.  Returns
    (film, the lanes whose shadow ray counted)."""
    cam_pos, _, _, _, w, h, _ = cam_info
    to_cam = cam_pos[None, :] - p
    dist = mm.length(to_cam)
    d_c = to_cam / torch.clamp(dist, min=1e-12)[..., None]
    sx, sy, inside = project(cam_info, p)
    kern = camera_importance(cam_info, d_c)
    traced = active & inside
    # the other lanes (whose p may be inf or NaN past an escape) trace an
    # empty segment, whose result they do not read
    occ = occluded(pack, *empty_segments(pack, traced, p + d_c * 1e-4, d_c,
                                         dist * (1.0 - 1e-3)))
    contributes = traced & ~occ
    val = value_rgb * (kern / torch.clamp(dist * dist, min=1e-12))[..., None]
    val = torch.where(contributes[..., None], val, 0.0)
    # a NaN coordinate's lane adds 0 wherever its index lands
    px = torch.clamp((sx * w).to(torch.int64), 0, w - 1)
    py = torch.clamp((sy * h).to(torch.int64), 0, h - 1)
    film.index_put_((py, px), val, accumulate=True)
    return film, traced


def make_ptracer_batch(pack, integ, sen, w, h, seed):
    """fn(film, lane, sidx) -> (film, n_rays): one batch of particles
    traced and splatted into film [H, W, 3]; n_rays counts the
    closest-hit and camera-connection rays it traced (an int64 tensor)."""
    max_depth = integ.max_depth if integ.max_depth > 0 else 16
    rr_depth = max(integ.rr_depth, 1)
    present = pack.meta["present_types"]
    seed_l = rng.stream_seed(seed, rng.STREAM_LIGHT)

    def run_batch(film, lane, sidx):
        cam_info = camera_info(sen, w, h, film.device)
        p0, n0, d0, beta, is_area, e0 = _sample_emitter_ray(pack, lane, sidx, seed)
        # the emitter seen directly (t = 1): Le * area / pmf * cos
        le, area, pmf = pack.em_rgb[e0], pack.em_area[e0], pack.emitter_pmf[e0]
        d_c = mm.normalize(cam_info[0][None, :] - p0)
        cos_p = torch.clamp(mm.dot(n0, d_c), min=0.0)
        val0 = le * ((area / torch.clamp(pmf, min=1e-12)) * cos_p)[..., None]
        o = p0 + n0 * 1e-4
        film, traced = _connect_to_camera(pack, cam_info, o, val0, film, is_area)
        n_rays = traced.sum()

        d = d0
        active = beta.amax(dim=-1) > 0
        live = LiveLanes(lane.shape[0], lane.device)
        for depth in range(max_depth):
            if depth % lanes.EXIT_CHECK_EVERY == 0:
                sub = live.narrow(active, o, d, beta, active, lane, sidx)
                if sub is None:
                    break
                o, d, beta, active, lane, sidx = sub
            n_rays = n_rays + active.sum()
            hit = intersect(pack, o, d)
            its = fill_interaction(pack, o, d, hit)
            active = active & its.valid
            frame = shading_frame(pack, its)
            wi_l = frame.to_local(its.wi_world)
            sp = shading_params(pack, its.mat, its.uv, its=its)

            # connect this vertex to the camera
            d_c = mm.normalize(cam_info[0][None, :] - its.p)
            f = bsdf_eval(sp, wi_l, frame.to_local(d_c), present)
            film, traced = _connect_to_camera(
                pack, cam_info, _path._offset_ray(its.p, its.ng, d_c), beta * f, film, active
            )
            n_rays = n_rays + traced.sum()

            # continue the walk (importance transport)
            u_b = rng.rand4(lane, sidx, depth * _SLOTS + 2, seed_l)
            bs = bsdf_sample(sp, wi_l, u_b[..., :2], u_b[..., 2], present)
            beta = beta * torch.where(active[..., None], bs.weight, 1.0)
            d_new = frame.to_world(bs.wo)
            o_new = _path._offset_ray(its.p, its.ng, d_new)
            active = active & (beta.amax(dim=-1) > 0)

            u_r = rng.rand4(lane, sidx, depth * _SLOTS + 3, seed_l)[..., 0]
            q = torch.clamp(beta.amax(dim=-1) * 0.0 + 0.95, max=0.95)
            do_rr = depth + 1 >= rr_depth
            keep = u_r < q if do_rr else torch.ones_like(active)
            if do_rr:
                beta = torch.where(keep[..., None], beta / q[..., None], beta)
            active = active & keep
            a3 = active[..., None]
            o = torch.where(a3, o_new, o)
            d = torch.where(a3, d_new, d)
        return film, n_rays

    return run_batch


def render_ptracer(scene, spp=None, seed=0, pack=None, device="cuda"):
    """Particle-traced render on `device`; image units match the path
    tracer.  `spp` is particles per pixel.  The batch index is the
    counter RNG's sample index.  Returns numpy [H, W, 3]; the rays traced
    are left in render_ptracer.last_ray_count."""
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device)
    if pack is None:
        pack = pack_scene(scene, device)
    sen = scene.sensor.record
    w, h = sen.film.width, sen.film.height
    spp = spp or sen.sampler.sample_count
    n_total = spp * w * h
    batch = min(n_total, BATCH_MAX)
    n_batches = max(n_total // batch, 1)
    run = make_ptracer_batch(pack, scene.integrator, sen, w, h, seed)
    film = torch.zeros(h, w, 3, dtype=torch.float32, device=device)
    lane = torch.arange(batch, dtype=torch.int64, device=device)
    n_rays = torch.zeros((), dtype=torch.int64, device=device)
    for b in range(n_batches):
        film, n = run(film, lane, torch.full_like(lane, b))
        n_rays = n_rays + n
    render_ptracer.last_ray_count = n_rays
    return (film * (1.0 / (n_batches * batch))).cpu().numpy()
