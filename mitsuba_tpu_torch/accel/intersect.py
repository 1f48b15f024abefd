"""Ray-scene intersection (port of mitsuba_tpu/accel/intersect.py, the
brute-force branch for scenes of at most 512 triangles).

`intersect` and `occluded` go through the K1/K2 wrappers of
accel/pallas_kernels.py: the CUDA kernels for tensors on a GPU, their
plain versions for tensors on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_tpu_torch.accel import pallas_kernels as pk
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.gather import take_fused

RAY_EPS = pk.RAY_EPS


class Hit(NamedTuple):
    valid: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R]
    prim: torch.Tensor  # [R] int32 triangle id, -1 on a miss
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
    """Hit record from K1 (`closest_fn`): an infinite t_max goes to the
    kernel as 1e30, a miss keeps t_max, and the winner's (u, v) are
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
    return Hit(valid=valid, t=best_t, prim=prim, u=u, v=v)


def _brute_force(pack, o, d, t_max):
    """Closest hit by the plain K1 on any device: (t, prim, u, v)."""
    h = _closest(pack, o, d, t_max, pk.closest_hit_plain)
    return h.t, h.prim, h.u, h.v


def _brute_force_any(pack, o, d, t_max):
    """Boolean any-hit by the plain K2 on any device."""
    return pk.any_hit_plain(o, d, _t_max_rays(t_max, o), pack.tri_s)


def intersect(pack, o, d, t_max=math.inf) -> Hit:
    """Closest-hit query (= Scene::rayIntersect, reference scene.h:187)."""
    return _closest(pack, o, d, t_max, pk.closest_hit_v2)


def occluded(pack, o, d, t_max) -> torch.Tensor:
    """Boolean shadow query; t_max is already shortened by the caller."""
    return pk.any_hit_v2(o, d, t_max, pack.tri_s)


def fill_interaction(pack, o, d, hit: Hit) -> SurfaceInteraction:
    """Per-hit surface data (= fillIntersectionRecord, reference
    records.inl), triangle branch."""
    prim = torch.clamp(hit.prim, min=0)
    e1, e2, n0, n1, n2, tuv0, tuv1, tuv2, mat, emit = take_fused(
        prim, pack.tri_e1, pack.tri_e2, pack.tri_n0, pack.tri_n1,
        pack.tri_n2, pack.tri_uv0, pack.tri_uv1, pack.tri_uv2,
        pack.tri_mat, pack.tri_emit,
    )
    u, v = hit.u[:, None], hit.v[:, None]
    w = 1.0 - hit.u - hit.v
    ng = mm.normalize(mm.cross(e1, e2))
    ns = mm.normalize(w[:, None] * n0 + u * n1 + v * n2)
    uv = w[:, None] * tuv0 + u * tuv1 + v * tuv2
    p = o + hit.t[:, None] * d
    # orient the geometric normal to the shading normal's hemisphere
    ng = torch.where((mm.dot(ng, ns) < 0.0)[:, None], -ng, ng)
    return SurfaceInteraction(
        valid=hit.valid, t=hit.t, p=p, ng=ng, ns=ns, uv=uv, mat=mat,
        emit=emit, prim=hit.prim, wi_world=-d,
        bary=torch.stack([hit.u, hit.v], dim=-1),
    )
