"""Ray-scene intersection (port of mitsuba_tpu/accel/intersect.py, the
triangle and sphere branches of `intersect` / `occluded`).

Scenes of at most 512 triangles go through the K1/K2 wrappers of
accel/pallas_kernels.py, BVH scenes through the pair pipeline of
accel/pairs.py (K3/K4, with the K7/K8 fallback): the CUDA kernels for
tensors on a GPU, their plain versions for tensors on the CPU.  Analytic
spheres are tested after the triangles with plain tensor operations, as
the reference tests them with XLA operations.
`fill_interaction` also reads the media on either side of a hit.
`_bvh_traverse` / `_bvh_traverse_any` are the reference's stackless BVH
walks (the path its intersect takes off the TPU), kept as the references
the tests hold the pair pipeline to.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_tpu_torch.accel import pairs
from mitsuba_tpu_torch.accel import pallas_kernels as pk
from mitsuba_tpu_torch.accel.bvh import LEAF_SIZE
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.gather import take_fused

RAY_EPS = pk.RAY_EPS


class Hit(NamedTuple):
    valid: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R]
    prim: torch.Tensor  # [R] int32 triangle or sphere id, -1 on a miss
    is_sphere: torch.Tensor | None  # [R] bool, prim is a sphere id; None without spheres
    u: torch.Tensor  # [R] barycentric
    v: torch.Tensor  # [R]


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


def intersect(pack, o, d, t_max=math.inf) -> Hit:
    """Closest-hit query (= Scene::rayIntersect, reference scene.h:187):
    the triangles (K1, or the pair pipeline), then the spheres."""
    r = o.shape[0]
    if pack.meta.get("n_tris", 1) == 0:
        best_t = _t_max_rays(t_max, o)
        prim = torch.full((r,), -1, dtype=torch.int32, device=o.device)
        u = v = torch.zeros(r, dtype=torch.float32, device=o.device)
    elif pack.meta.get("use_bvh", False):
        best_t, prim, u, v = pairs.pair_closest(pack, o, d, t_max)
    else:
        best_t, prim, u, v = _closest(pack, o, d, t_max, pk.closest_hit_v2)
    is_sphere = None
    if pack.meta.get("n_spheres", 0) > 0:
        sh, st, sid = _intersect_spheres(pack, o, d, best_t)
        is_sphere = sh & (st < best_t)
        best_t = torch.where(is_sphere, st, best_t)
        prim = torch.where(is_sphere, sid, prim)
    return Hit(valid=prim >= 0, t=best_t, prim=prim, is_sphere=is_sphere, u=u, v=v)


def occluded(pack, o, d, t_max) -> torch.Tensor:
    """Boolean shadow query; t_max is already shortened by the caller.
    The triangles (K2, or the pair pipeline), ORed with the spheres."""
    if pack.meta.get("n_tris", 1) == 0:
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    elif pack.meta.get("use_bvh", False):
        occ = pairs.pair_any(pack, o, d, t_max)
    else:
        occ = pk.any_hit_v2(o, d, t_max, pack.tri_s)
    if pack.meta.get("n_spheres", 0) > 0:
        sh, _, _ = _intersect_spheres(pack, o, d, _t_max_rays(t_max, o))
        occ = occ | sh
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


def fill_interaction(pack, o, d, hit: Hit) -> SurfaceInteraction:
    """Per-hit surface data (= fillIntersectionRecord, reference
    records.inl): the triangle branch, and the sphere branch where the
    hit is a sphere (reference intersect.py:911-928)."""
    has_spheres = pack.meta.get("n_spheres", 0) > 0
    prim = torch.clamp(hit.prim, min=0)
    # a lane gathers only from its own kind's tables: a sphere id may lie
    # past the triangle tables and a triangle id past the sphere tables
    # (the reference's one-hot gathers return a row of zeros there)
    tri_id = torch.where(hit.is_sphere, 0, prim) if has_spheres else prim
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
        med_in = torch.where(hit.valid, med_in, -1)
        med_ex = torch.where(hit.valid, med_ex, -1)
    else:
        med_in = med_ex = None
    return SurfaceInteraction(
        valid=hit.valid, t=hit.t, p=p, ng=ng, ns=ns, uv=uv, mat=mat,
        emit=emit, prim=hit.prim, wi_world=-d,
        bary=torch.stack([hit.u, hit.v], dim=-1), med_in=med_in, med_ex=med_ex,
    )
