"""Ray-scene intersection (port of mitsuba_tpu/accel/intersect.py: the
triangle, animated, deformable, sphere and segment arms of `intersect` /
`occluded`).

Scenes of at most 512 triangles go through the K1/K2 wrappers of
accel/pallas_kernels.py, BVH scenes through the pair pipeline of
accel/pairs.py (K3/K4, with the K7/K8 fallback): the CUDA kernels for
tensors on a GPU, their plain versions for tensors on the CPU.  Analytic
spheres, then analytic cylinder segments (accel/cyl.py), are tested after
the triangles with plain tensor operations, as the reference tests them
with XLA operations.
`fill_interaction` also reads the media on either side of a hit, and the
uv partials where bump maps or mip maps need them.
`_bvh_traverse` / `_bvh_traverse_any` are the reference's stackless BVH
walks (the path its intersect takes off the TPU), kept as the references
the tests hold the pair pipeline to.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_tpu_torch.accel import cyl, pairs
from mitsuba_tpu_torch.accel import pallas_kernels as pk
from mitsuba_tpu_torch.accel.bvh import LEAF_SIZE
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.gather import take_fused

RAY_EPS = pk.RAY_EPS


class Hit(NamedTuple):
    valid: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R]
    prim: torch.Tensor  # [R] int32 triangle, sphere or segment id, -1 on a miss
    is_sphere: torch.Tensor | None  # [R] bool, prim is a sphere id; None without spheres
    u: torch.Tensor  # [R] barycentric
    v: torch.Tensor  # [R]
    # [R] bool, prim is a cylinder segment id; None without segments (and
    # where an integrator builds a Hit of triangles and spheres)
    is_cyl: torch.Tensor | None = None


class SurfaceInteraction(NamedTuple):
    valid: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor  # [R, 3]
    ng: torch.Tensor  # geometric normal (shading-normal hemisphere)
    ns: torch.Tensor  # shading normal
    uv: torch.Tensor  # [R, 2]
    mat: torch.Tensor  # material id
    emit: torch.Tensor  # emitter id (-1 none)
    prim: torch.Tensor
    wi_world: torch.Tensor  # -ray.d
    bary: torch.Tensor  # [R, 2] triangle barycentrics
    # interior / exterior medium ids (-1 vacuum, and on a miss); None in a
    # scene without media, where nothing reads them
    med_in: torch.Tensor | None
    med_ex: torch.Tensor | None
    # [R, 3] uv partials dp/du, dp/dv (bump and normal maps, mip
    # footprints); zeros in a scene without either, None where an
    # interaction is built without them
    dpdu: torch.Tensor | None = None
    dpdv: torch.Tensor | None = None


def _moller_trumbore(o, d, v0, e1, e2, t_max):
    """Batched Moller-Trumbore; arguments broadcast to [..., 3].
    Returns (hit_mask, t, u, v)."""
    pvec = mm.cross(d, e2)
    det = mm.dot(e1, pvec)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = o - v0
    u = mm.dot(tvec, pvec) * inv_det
    qvec = mm.cross(tvec, e1)
    v = mm.dot(d, qvec) * inv_det
    t = mm.dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_EPS) & (t < t_max)
    return hit, t, u, v


def _t_max_rays(t_max, o):
    return torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(
        o.shape[0]
    )


def _closest(pack, o, d, t_max, closest_fn):
    """(t, prim, u, v) from K1 (`closest_fn`): an infinite t_max goes to
    the kernel as 1e30, a miss keeps t_max, and the winner's (u, v) are
    recomputed (reference intersect.py:730-745)."""
    tm = _t_max_rays(t_max, o)
    best_t, prim = closest_fn(
        o, d, torch.where(torch.isfinite(tm), tm, 1e30), pack.tri_s
    )
    valid = prim >= 0
    best_t = torch.where(valid, best_t, tm)
    v0, e1, e2 = take_fused(
        torch.clamp(prim, min=0), pack.tri_v0, pack.tri_e1, pack.tri_e2
    )
    _, _, u, v = _moller_trumbore(o, d, v0, e1, e2, math.inf)
    u = torch.where(valid, u, 0.0)
    v = torch.where(valid, v, 0.0)
    return best_t, prim, u, v


def _brute_force(pack, o, d, t_max):
    """Closest hit by the plain K1 on any device: (t, prim, u, v)."""
    return _closest(pack, o, d, t_max, pk.closest_hit_plain)


def _brute_force_any(pack, o, d, t_max):
    """Boolean any-hit by the plain K2 on any device."""
    return pk.any_hit_plain(o, d, _t_max_rays(t_max, o), pack.tri_s)


def _bvh_setup(pack, d, octants):
    """(end, first-node offset [R] of each ray's layout, 1/d)."""
    n_layouts = pack.meta.get("bvh_n_layouts", 1)
    end = pack.bvh_nodes.shape[0] // n_layouts
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    if octants and n_layouts == 8:
        oct_ = (d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long() + 4 * (d[:, 2] < 0).long()
        base = oct_ * end
    else:
        base = torch.zeros(d.shape[0], dtype=torch.int64, device=d.device)
    return end, base, inv_d


def _bvh_step(pack, o, inv_d, node, base, end, t_lim):
    """One lockstep step of every ray: its node's slab test against
    t_lim, and its leaf triangles.  Returns (active, box_hit, is_leaf,
    skip, tidx [R, LEAF_SIZE], t9 [R, LEAF_SIZE, 9])."""
    active = node < end
    ni = torch.clamp(node, max=end - 1)
    nd = pack.bvh_nodes[base + ni]
    lo, hi = nd[:, 0:3], nd[:, 3:6]
    first, count, skip = nd[:, 6].long(), nd[:, 7].long(), nd[:, 8].long()
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    box_hit = (tf >= torch.clamp(tn, min=0.0)) & (tn < t_lim)
    is_leaf = count > 0
    lanes = torch.arange(LEAF_SIZE, device=o.device)[None]
    tidx = torch.where(lanes < count[:, None], first[:, None] + lanes,
                       pack.tri9.shape[0] - 1)  # padded far-away triangle
    return active, box_hit, is_leaf, skip, tidx, pack.tri9[tidx]


def _bvh_traverse(pack, o, d, t_max):
    """Closest hit by the stackless walk over the threaded BVH
    (reference intersect.py:195-286); each ray walks the node layout of
    its direction octant.  Returns (t, prim, u, v); t = t_max on a miss."""
    r = o.shape[0]
    end, base, inv_d = _bvh_setup(pack, d, octants=True)
    node = torch.zeros(r, dtype=torch.int64, device=o.device)
    best_t = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r).clone()
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros(r, dtype=torch.float32, device=o.device)
    best_v = torch.zeros(r, dtype=torch.float32, device=o.device)
    while bool((node < end).any()):
        active, box_hit, is_leaf, skip, tidx, t9 = _bvh_step(
            pack, o, inv_d, node, base, end, best_t
        )
        hit, t, u, v = _moller_trumbore(
            o[:, None], d[:, None], t9[..., 0:3], t9[..., 3:6], t9[..., 6:9],
            best_t[:, None],
        )
        hit = hit & (box_hit & is_leaf & active)[:, None]
        t = torch.where(hit, t, torch.inf)
        tk, k = t.min(dim=-1)
        better = tk < best_t
        k = k[:, None]
        best_prim = torch.where(better, tidx.gather(1, k)[:, 0].to(torch.int32), best_prim)
        best_u = torch.where(better, u.gather(1, k)[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, k)[:, 0], best_v)
        best_t = torch.minimum(best_t, tk)
        nxt = torch.where(box_hit & ~is_leaf, node + 1, skip)
        node = torch.where(active, nxt, node)
    return best_t, best_prim, best_u, best_v


def _bvh_traverse_any(pack, o, d, t_max):
    """Any-hit walk over the threaded BVH (reference intersect.py:289-352):
    a ray stops at its first hit."""
    r = o.shape[0]
    end, base, inv_d = _bvh_setup(pack, d, octants=False)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r)
    node = torch.zeros(r, dtype=torch.int64, device=o.device)
    occ = torch.zeros(r, dtype=torch.bool, device=o.device)
    while bool((node < end).any()):
        active, box_hit, is_leaf, skip, _, t9 = _bvh_step(
            pack, o, inv_d, node, base, end, t_max
        )
        hit, _, _, _ = _moller_trumbore(
            o[:, None], d[:, None], t9[..., 0:3], t9[..., 3:6], t9[..., 6:9],
            t_max[:, None],
        )
        found = (hit & (box_hit & is_leaf & active)[:, None]).any(dim=-1)
        occ = occ | found
        nxt = torch.where(box_hit & ~is_leaf, node + 1, skip)
        nxt = torch.where(found, end, nxt)  # early exit on the first hit
        node = torch.where(active, nxt, node)
    return occ


def _intersect_spheres(pack, o, d, best_t):
    """Analytic sphere test (reference src/shapes/sphere.cpp rayIntersect,
    intersect.py:65-95) over [S, R]: (hit, t, sphere id), hit where the
    nearest sphere lies below best_t; ties keep the lower id."""
    cen = pack.sph_center  # [S, 3]
    oc = o[None] - cen[:, None]  # [S, R, 3]
    ocx, ocy, ocz = oc[..., 0], oc[..., 1], oc[..., 2]
    dx, dy, dz = d[None, :, 0], d[None, :, 1], d[None, :, 2]
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = ocx * ocx + ocy * ocy + ocz * ocz - (pack.sph_radius ** 2)[:, None]
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = 0.5 * (-b - sq)
    t1 = 0.5 * (-b + sq)
    t = torch.where(t0 > RAY_EPS, t0, t1)
    ok = (disc >= 0.0) & (t > RAY_EPS) & (pack.sph_radius[:, None] > 0.0)
    t = torch.where(ok, t, torch.inf)
    tmin = t.amin(dim=0)
    # the first minimum on ties, as jnp.argmin (torch.min leaves the
    # index of a tie unspecified on the GPU)
    ids = torch.arange(t.shape[0], dtype=torch.int32, device=t.device)[:, None]
    sid = torch.where(t == tmin, ids, t.shape[0]).amin(dim=0)
    return tmin < best_t, tmin, torch.clamp(sid, max=t.shape[0] - 1)


# ---- animated and deformable shapes (reference intersect.py:471-695) ----
# Their triangle rows follow the static prefix (meta n_static_tris), which
# alone the accelerators and K1/K2 cover; each range is tested here with
# plain tensor operations, as the reference tests it with XLA operations,
# in tiles of TRI_TILE rows (a range of fewer rows is one tile of its own
# width: rows past a range are never hit).
TRI_TILE = 128


def _static_tris(pack):
    return pack.meta.get("n_static_tris", pack.meta.get("n_tris", 1))


def _shutter(time, o):
    """[R] float32 shutter times; None is the shutter midpoint 0.5."""
    if time is None:
        return torch.full((o.shape[0],), 0.5, dtype=torch.float32, device=o.device)
    return torch.as_tensor(time, dtype=torch.float32, device=o.device).expand(o.shape[0])


def _tiles(count):
    """(tile width, rows padded to whole tiles)."""
    tw = min(TRI_TILE, max(count, 1))
    return tw, -(-count // tw) * tw


def _pad_rows(a, n, fill):
    if a.shape[0] >= n:
        return a[:n]
    return torch.cat([a, torch.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype,
                                    device=a.device)])


def _anim_ray(o, d, m1, tt):
    """World rays into an animated shape's keyframe-0 frame: M(t) = I + t
    (M1 - I) lerped per lane and inverted in closed form by its adjugate
    (reference intersect.py:471-504, AnimatedTransform::eval).  d2 is not
    normalized, so t stays the world ray's t."""
    eye = torch.eye(3, dtype=torch.float32, device=o.device)
    l1 = m1[:9].reshape(3, 3)
    b1 = m1[9:12]
    tt3 = tt[..., None]
    a = eye + tt3[..., None] * (l1 - eye)[None]  # [R, 3, 3]
    b = tt3 * b1[None]
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)

    def apply_inv(v):
        x = c00 * v[..., 0] + c01 * v[..., 1] + c02 * v[..., 2]
        y = c10 * v[..., 0] + c11 * v[..., 1] + c12 * v[..., 2]
        z = c20 * v[..., 0] + c21 * v[..., 1] + c22 * v[..., 2]
        return torch.stack([x, y, z], dim=-1) * inv_det[..., None]

    return apply_inv(o - b), apply_inv(d)


def _tile_closest(o, d, v0, e1, e2, first, best_t, best_prim, best_u, best_v):
    """Fold one tile's nearest hit below best_t into the running closest
    hit; a tie keeps the earlier row, as jnp.argmin does."""
    hit, t, u, v = _moller_trumbore(o[:, None], d[:, None], v0, e1, e2, best_t[:, None])
    t = torch.where(hit, t, torch.inf)
    tk = t.amin(dim=-1)
    cols = torch.arange(t.shape[1], dtype=torch.int64, device=t.device)[None]
    k = torch.where(t == tk[:, None], cols, t.shape[1]).amin(dim=-1, keepdim=True)
    better = tk < best_t
    best_prim = torch.where(better, first + k[:, 0].to(torch.int32), best_prim)
    best_u = torch.where(better, u.gather(1, k)[:, 0], best_u)
    best_v = torch.where(better, v.gather(1, k)[:, 0], best_v)
    return torch.minimum(best_t, tk), best_prim, best_u, best_v


def _anim_rows(pack, first, count):
    tw, pad_to = _tiles(count)
    rows = [
        _pad_rows(a[first:first + count], pad_to, fill)
        for a, fill in ((pack.tri_v0, 1e30), (pack.tri_e1, 0.0), (pack.tri_e2, 0.0))
    ]
    return tw, pad_to, rows


def _anim_closest(pack, o, d, time, best_t, best_prim, best_u, best_v):
    """Animated shapes (reference intersect.py:507-552): each range's rays
    in its keyframe-0 frame at the lane's time, then brute force over its
    rows."""
    tt = _shutter(time, o)
    for a, (first, count) in enumerate(pack.meta["anim_ranges"]):
        o2, d2 = _anim_ray(o, d, pack.anim_m1[a], tt)
        tw, pad_to, (v0, e1, e2) = _anim_rows(pack, first, count)
        for t0 in range(0, pad_to, tw):
            sl = slice(t0, t0 + tw)
            best_t, best_prim, best_u, best_v = _tile_closest(
                o2, d2, v0[None, sl], e1[None, sl], e2[None, sl], first + t0,
                best_t, best_prim, best_u, best_v)
    return best_t, best_prim, best_u, best_v


def _anim_any(pack, o, d, time, t_max):
    """Any hit on the animated shapes below t_max (reference
    intersect.py:555-578)."""
    tt = _shutter(time, o)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    tm = _t_max_rays(t_max, o)[:, None]
    for a, (first, count) in enumerate(pack.meta["anim_ranges"]):
        o2, d2 = _anim_ray(o, d, pack.anim_m1[a], tt)
        tw, pad_to, (v0, e1, e2) = _anim_rows(pack, first, count)
        for t0 in range(0, pad_to, tw):
            sl = slice(t0, t0 + tw)
            hit, _, _, _ = _moller_trumbore(o2[:, None], d2[:, None], v0[None, sl],
                                            e1[None, sl], e2[None, sl], tm)
            occ = occ | hit.any(dim=-1)
    return occ


def _deform_frames(pack, rr_, count, times, tt):
    """The keyframe pair of each lane's time for deformable range rr_
    (reference intersect.py:581-633): seg clamped to [0, k - 2], w to [0,
    1] over the segment (its length floored at 1e-9).  The reference's
    one-hot [R, K] x [K, tile * 9] contraction becomes plain indexing of
    the lane's two frames; with k == 2 there is nothing to select.
    Returns (fetch(slice) -> lerped [R, tile, 9] rows, rows padded to
    whole tiles, v0 = 1e30 past the range)."""
    frames = pack.arrays[f"deform_tri9_{rr_}"]  # [K, T, 9]
    k = len(times)
    _, pad_to = _tiles(count)
    fp = frames
    if pad_to > count:
        pad = torch.zeros((k, pad_to - count, 9), dtype=frames.dtype, device=frames.device)
        pad[..., 0:3] = 1e30
        fp = torch.cat([frames, pad], dim=1)
    tgrid = torch.tensor(times, dtype=torch.float32, device=tt.device)
    seg = torch.clamp(torch.searchsorted(tgrid, tt.contiguous(), right=True) - 1, 0, k - 2)
    t0 = tgrid[seg]
    t1 = tgrid[torch.clamp(seg + 1, max=k - 1)]
    w = torch.clamp((tt - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)[:, None, None]
    if k == 2:
        def fetch(sl):
            a, b = fp[0, sl], fp[1, sl]
            return a[None] + w * (b - a)[None]
    else:
        def fetch(sl):
            a, b = fp[seg, sl], fp[seg + 1, sl]
            return a + w * (b - a)
    return fetch, pad_to


def _deform_closest(pack, o, d, time, best_t, best_prim, best_u, best_v):
    """Deformable shapes (reference intersect.py:636-672,
    deformable.cpp): each lane's rows lerped between the keyframes of its
    time, then brute force."""
    tt = _shutter(time, o)
    for rr_, (first, count, times) in enumerate(pack.meta["deform_ranges"]):
        fetch, pad_to = _deform_frames(pack, rr_, count, times, tt)
        tw = _tiles(count)[0]
        for t0 in range(0, pad_to, tw):
            tri = fetch(slice(t0, t0 + tw))
            best_t, best_prim, best_u, best_v = _tile_closest(
                o, d, tri[..., 0:3], tri[..., 3:6], tri[..., 6:9], first + t0,
                best_t, best_prim, best_u, best_v)
    return best_t, best_prim, best_u, best_v


def _deform_any(pack, o, d, time, t_max):
    """Any hit on the deformable shapes below t_max (reference
    intersect.py:675-695)."""
    tt = _shutter(time, o)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    tm = _t_max_rays(t_max, o)[:, None]
    for rr_, (first, count, times) in enumerate(pack.meta["deform_ranges"]):
        fetch, pad_to = _deform_frames(pack, rr_, count, times, tt)
        tw = _tiles(count)[0]
        for t0 in range(0, pad_to, tw):
            tri = fetch(slice(t0, t0 + tw))
            hit, _, _, _ = _moller_trumbore(o[:, None], d[:, None], tri[..., 0:3],
                                            tri[..., 3:6], tri[..., 6:9], tm)
            occ = occ | hit.any(dim=-1)
    return occ


def intersect(pack, o, d, t_max=math.inf, time=None) -> Hit:
    """Closest-hit query (= Scene::rayIntersect, reference scene.h:187):
    the static triangles (K1, or the pair pipeline), the animated, then
    the deformable shapes at the lanes' shutter `time` ([R], or None for
    the midpoint), then the spheres, then the cylinder segments
    (reference intersect.py:698-798)."""
    r = o.shape[0]
    if _static_tris(pack) == 0:
        best_t = _t_max_rays(t_max, o)
        prim = torch.full((r,), -1, dtype=torch.int32, device=o.device)
        u = v = torch.zeros(r, dtype=torch.float32, device=o.device)
    elif pack.meta.get("use_bvh", False):
        best_t, prim, u, v = pairs.pair_closest(pack, o, d, t_max)
    else:
        best_t, prim, u, v = _closest(pack, o, d, t_max, pk.closest_hit_v2)
    if pack.meta.get("anim_ranges", ()):
        best_t, prim, u, v = _anim_closest(pack, o, d, time, best_t, prim, u, v)
    if pack.meta.get("deform_ranges", ()):
        best_t, prim, u, v = _deform_closest(pack, o, d, time, best_t, prim, u, v)
    is_sphere = None
    if pack.meta.get("n_spheres", 0) > 0:
        sh, st, sid = _intersect_spheres(pack, o, d, best_t)
        is_sphere = sh & (st < best_t)
        best_t = torch.where(is_sphere, st, best_t)
        prim = torch.where(is_sphere, sid, prim)
    is_cyl = None
    if pack.meta.get("n_cyls", 0) > 0:
        ch, ct, cid = cyl.cyl_closest(pack, o, d, best_t)
        is_cyl = ch & (ct < best_t)
        best_t = torch.where(is_cyl, ct, best_t)
        prim = torch.where(is_cyl, cid, prim)
        if is_sphere is not None:  # a segment in front clears the sphere
            is_sphere = is_sphere & ~is_cyl
    return Hit(valid=prim >= 0, t=best_t, prim=prim, is_sphere=is_sphere, u=u, v=v,
               is_cyl=is_cyl)


def occluded(pack, o, d, t_max, time=None) -> torch.Tensor:
    """Boolean shadow query; t_max is already shortened by the caller.
    The static triangles (K2, or the pair pipeline), ORed with the
    spheres, the cylinder segments, then the animated and deformable
    shapes at `time`.  Without static triangles it is intersect's hit
    (reference intersect.py:801-854)."""
    if _static_tris(pack) == 0:
        return intersect(pack, o, d, t_max, time=time).valid
    if pack.meta.get("use_bvh", False):
        occ = pairs.pair_any(pack, o, d, t_max)
    else:
        occ = pk.any_hit_v2(o, d, t_max, pack.tri_s)
    if pack.meta.get("n_spheres", 0) > 0:
        sh, _, _ = _intersect_spheres(pack, o, d, _t_max_rays(t_max, o))
        occ = occ | sh
    if pack.meta.get("n_cyls", 0) > 0:
        occ = occ | cyl.cyl_any(pack, o, d, t_max)
    if pack.meta.get("anim_ranges", ()):
        occ = occ | _anim_any(pack, o, d, time, t_max)
    if pack.meta.get("deform_ranges", ()):
        occ = occ | _deform_any(pack, o, d, time, t_max)
    return occ


def empty_segments(pack, live, o, d, t):
    """(o, d, t) of shadow segments with the lanes outside `live` replaced
    by an empty segment (t = 0) that starts outside the scene's bounding
    sphere, so that it meets no cluster box; the occlusion queries settle
    t_max <= 0 as occluded."""
    c = pack.meta["scene_center"]
    far = torch.tensor([c[0], c[1], c[2] + 2.0 * pack.meta["scene_radius"] + 1.0],
                       dtype=torch.float32, device=o.device)
    l3 = live[..., None]
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=o.device)
    return torch.where(l3, o, far), torch.where(l3, d, z_axis), torch.where(live, t, 0.0)


# the reference gathers tables of at most this many rows by one-hot
# products (core/gather.py ONEHOT_MAX_ROWS), which give a row of zeros
# past the table, and larger ones by indexing, which clamps
_ONEHOT_MAX_ROWS = 512


def _partials(pack, p, hit, prim, tri_id, has_spheres, has_cyls):
    """(dpdu, dpdv) of each hit (reference intersect.py:985-1029): the
    triangle's tables; on a sphere the lat-long partials with their true
    magnitudes, |dp/du| = 2 pi r sin(theta), |dp/dv| = pi r.  A segment
    lane reads what the reference's gather by its segment id gives: that
    triangle row, or zeros past a table of at most _ONEHOT_MAX_ROWS rows
    (ROADMAP C4)."""
    dpdu, dpdv = take_fused(tri_id, pack.tri_dpdu, pack.tri_dpdv)
    if has_cyls:
        rows = pack.tri_dpdu.shape[0]
        seg_row = torch.clamp(prim, max=rows - 1)
        keep = (hit.is_cyl & ((prim < rows) | (rows > _ONEHOT_MAX_ROWS)))[:, None]
        dpdu = torch.where(hit.is_cyl[:, None], torch.where(keep, pack.tri_dpdu[seg_row], 0.0),
                           dpdu)
        dpdv = torch.where(hit.is_cyl[:, None], torch.where(keep, pack.tri_dpdv[seg_row], 0.0),
                           dpdv)
    if has_spheres:
        center, radius = take_fused(torch.where(hit.is_sphere, prim, 0), pack.sph_center,
                                    pack.sph_radius)
        rel = mm.normalize(p - center)
        sin_t = torch.sqrt(torch.clamp(1.0 - rel[..., 2] * rel[..., 2], min=1e-12))
        pc = p - center
        t_phi = mm.normalize(torch.stack([-pc[..., 1], pc[..., 0], torch.zeros_like(hit.t)],
                                         dim=-1))
        t_theta = mm.normalize(mm.cross(t_phi, rel))
        sph = hit.is_sphere[:, None]
        dpdu = torch.where(sph, t_phi * (2.0 * math.pi * radius * sin_t)[:, None], dpdu)
        dpdv = torch.where(sph, t_theta * (math.pi * radius)[:, None], dpdv)
    return dpdu, dpdv


def fill_interaction(pack, o, d, hit: Hit) -> SurfaceInteraction:
    """Per-hit surface data (= fillIntersectionRecord, reference
    records.inl): the triangle branch, the sphere branch where the hit is
    a sphere (reference intersect.py:911-928) and the segment branch where
    it is a cylinder segment (:931-949, :978-980)."""
    has_spheres = pack.meta.get("n_spheres", 0) > 0
    has_cyls = pack.meta.get("n_cyls", 0) > 0 and hit.is_cyl is not None
    prim = torch.clamp(hit.prim, min=0)
    # a lane gathers only from its own kind's tables: a sphere or segment
    # id may lie past the triangle tables, a triangle id past the others
    # (the reference's one-hot gathers return a row of zeros there)
    tri_id = torch.where(hit.is_sphere, 0, prim) if has_spheres else prim
    if has_cyls:
        tri_id = torch.where(hit.is_cyl, 0, tri_id)
    e1, e2, n0, n1, n2, tuv0, tuv1, tuv2, mat, emit = take_fused(
        tri_id, pack.tri_e1, pack.tri_e2, pack.tri_n0, pack.tri_n1,
        pack.tri_n2, pack.tri_uv0, pack.tri_uv1, pack.tri_uv2,
        pack.tri_mat, pack.tri_emit,
    )
    u, v = hit.u[:, None], hit.v[:, None]
    w = 1.0 - hit.u - hit.v
    ng = mm.normalize(mm.cross(e1, e2))
    ns = mm.normalize(w[:, None] * n0 + u * n1 + v * n2)
    uv = w[:, None] * tuv0 + u * tuv1 + v * tuv2
    p = o + hit.t[:, None] * d
    if has_spheres:
        center, flip_s, mat_s, emit_s = take_fused(
            torch.where(hit.is_sphere, prim, 0), pack.sph_center, pack.sph_flip,
            pack.sph_mat, pack.sph_emit,
        )
        n_sph = mm.normalize(p - center)
        ns_sph = n_sph * flip_s[:, None]
        theta = mm.safe_acos(n_sph[..., 2])
        phi = torch.arctan2(n_sph[..., 1], n_sph[..., 0])
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
        uv_sph = torch.stack([phi / (2 * math.pi), theta / math.pi], dim=-1)
        sphere = hit.is_sphere
        ng = torch.where(sphere[:, None], ns_sph, ng)
        ns = torch.where(sphere[:, None], ns_sph, ns)
        uv = torch.where(sphere[:, None], uv_sph, uv)
        mat = torch.where(sphere, mat_s, mat)
        emit = torch.where(sphere, emit_s, emit)
    if has_cyls:
        # the radial normal: p - p0 without its part along the axis
        # (reference hair.cpp fillIntersectionRecord:838-846); uv stays 0
        # and the segment emits nothing
        cp0, cp1, cmat, cflip = take_fused(
            torch.where(hit.is_cyl, prim, 0), pack.cyl_p0, pack.cyl_p1, pack.cyl_mat,
            pack.cyl_flip,
        )
        cax = mm.normalize(cp1 - cp0)
        rel = p - cp0
        n_cyl = mm.normalize(rel - mm.dot(rel, cax, keepdim=True) * cax) * cflip[:, None]
        seg = hit.is_cyl
        ng = torch.where(seg[:, None], n_cyl, ng)
        ns = torch.where(seg[:, None], n_cyl, ns)
        uv = torch.where(seg[:, None], 0.0, uv)
        mat = torch.where(seg, cmat, mat)
        emit = torch.where(seg, -1, emit)
    # orient the geometric normal to the shading normal's hemisphere
    ng = torch.where((mm.dot(ng, ns) < 0.0)[:, None], -ng, ng)
    if pack.meta.get("has_media", False):
        # the media on either side (reference intersect.py:963-976), from
        # the lane's own kind's table
        med_in, med_ex = take_fused(tri_id, pack.tri_med_in, pack.tri_med_ex)
        if has_spheres:
            med_in_s, med_ex_s = take_fused(
                torch.where(hit.is_sphere, prim, 0), pack.sph_med_in, pack.sph_med_ex
            )
            med_in = torch.where(hit.is_sphere, med_in_s, med_in)
            med_ex = torch.where(hit.is_sphere, med_ex_s, med_ex)
        if has_cyls:  # segments carry no media
            med_in = torch.where(hit.is_cyl, -1, med_in)
            med_ex = torch.where(hit.is_cyl, -1, med_ex)
        med_in = torch.where(hit.valid, med_in, -1)
        med_ex = torch.where(hit.valid, med_ex, -1)
    else:
        med_in = med_ex = None
    if pack.meta.get("has_bumpmaps", False) or pack.meta.get("has_mips", False):
        dpdu, dpdv = _partials(pack, p, hit, prim, tri_id, has_spheres, has_cyls)
    else:
        dpdu = dpdv = torch.zeros_like(ng)
    return SurfaceInteraction(
        valid=hit.valid, t=hit.t, p=p, ng=ng, ns=ns, uv=uv, mat=mat,
        emit=emit, prim=hit.prim, wi_world=-d,
        bary=torch.stack([hit.u, hit.v], dim=-1), med_in=med_in, med_ex=med_ex,
        dpdu=dpdu, dpdv=dpdv,
    )
