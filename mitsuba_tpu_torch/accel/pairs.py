"""Pair traversal for big meshes (port of mitsuba_tpu/accel/pairs.py, the
path the reference takes for meshes of at most DENSE_C clusters):

  1. exact per-ray culling (K3, `_dense_cull_kernel`): every ray
     slab-tests every cluster box and keeps its K nearest clusters,
     entry-sorted, plus the overflow statistics (n_cl, kept_max);
  2. pair hits (K4, `_runs_kernel`): each (ray, kept cluster) pair runs
     Moller-Trumbore over the cluster's Tc triangles; the min over the K
     slots, ties to the nearest slot, is the ray's hit;
  3. rays whose list overflowed (more than K clusters hit, and no hit
     before the K-th entry) re-run through the per-ray cluster traversal
     (K7/K8, accel/pallas_bvh.py).

The reference's pair queue, cluster sort, BUDGET, W-windows and run lists
(pairs.py:488-620) exist to give the TPU static shapes and are not
ported: K4 reads the [R, K] lists directly, so no pair is ever dropped
and the reference's "dropped" overflow class cannot occur.  Nor is the
two-level cull (K5/K6), which the reference takes above DENSE_C clusters.

Each kernel wrapper launches its CUDA kernel (csrc/cluster_hit.cu) for
tensors on a GPU and runs its plain PyTorch version for tensors on the
CPU; there is no fallback from one to the other.  Each counts its kernel
launches in `.launches`.  `pair_closest` and `pair_any` count the rays
they were given in `.rays` and those that took the fallback in
`.overflow_rays`.
"""

from __future__ import annotations

import torch

from mitsuba_tpu_torch import native
from mitsuba_tpu_torch.accel import pallas_bvh as pb
from mitsuba_tpu_torch.accel.pallas_kernels import mt_test

BIG = pb.BIG
# clusters kept per ray; a test or a smoke run may lower it to force the
# overflow fallback, as the reference's tests do
K = 3
# the reference's dense-cull bound (pairs.py:192-193: its VMEM budget at
# 512-ray blocks); above it the reference runs K5/K6
DENSE_C = 1890
# (ray, slot) pairs per step of the plain K4
PLAIN_PAIR_CHUNK = 1 << 16


# ---------------------------------------------------------------------------
# K3: dense cull
# ---------------------------------------------------------------------------

def dense_cull_plain(o, d, t_max, cl_mbox, c, kk):
    """Plain K3.  o, d: [R, 3]; t_max: [R] finite; cl_mbox: [Sp, G*6]
    (its first c rows of 6 are the cluster boxes).  Returns (cid [R, kk]
    i32, c = empty; entry [R, kk] ascending, BIG = empty; n_cl [R] i32:
    clusters hit; kept_max [R]: the kk-th entry)."""
    boxes = cl_mbox.reshape(-1, 6)[:c]
    inv = pb.safe_inv(d)
    r = o.shape[0]
    cid = torch.empty(r, kk, dtype=torch.int32, device=o.device)
    ent = torch.empty(r, kk, dtype=torch.float32, device=o.device)
    n_cl = torch.empty(r, dtype=torch.int32, device=o.device)
    for s, e in pb._chunks(r):
        tn = torch.full((e - s, c), -BIG, dtype=torch.float32, device=o.device)
        tf = torch.full((e - s, c), BIG, dtype=torch.float32, device=o.device)
        for a in range(3):
            t0 = (boxes[None, :, a] - o[s:e, a:a + 1]) * inv[s:e, a:a + 1]
            t1 = (boxes[None, :, 3 + a] - o[s:e, a:a + 1]) * inv[s:e, a:a + 1]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        en = torch.clamp(tn, min=0.0)
        hit = (tf >= en) & (tn < t_max[s:e, None])
        key = torch.where(hit, en, BIG)
        # the kk smallest, ties by cluster id (a stable sort's order)
        val, idx = torch.sort(key, dim=1, stable=True)
        ent[s:e] = val[:, :kk]
        cid[s:e] = torch.where(val[:, :kk] < BIG, idx[:, :kk], c).to(torch.int32)
        n_cl[s:e] = hit.sum(dim=1, dtype=torch.int32)
    return cid, ent, n_cl, ent[:, kk - 1].clone()


def dense_cull(o, d, t_max, cl_mbox, c, kk):
    """K3: see dense_cull_plain."""
    r = o.shape[0]
    native.check_tensors(
        o, ("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
        ("t_max", t_max, torch.float32, (r,)),
        ("cl_mbox", cl_mbox, torch.float32, None),
    )
    if cl_mbox.numel() < 6 * c or not 1 <= kk <= c:
        raise ValueError(f"cl_mbox {tuple(cl_mbox.shape)} / kk {kk} do not fit {c} clusters")
    o, d, t_max, cl_mbox = (x.contiguous() for x in (o, d, t_max, cl_mbox))
    if o.device.type == "cpu":
        return dense_cull_plain(o, d, t_max, cl_mbox, c, kk)
    max_c, max_k = pb.kernel_limits()
    if c > max_c or kk > max_k:
        raise ValueError(f"the cull kernel takes at most {max_c} clusters and "
                         f"K <= {max_k}, got {c} and {kk}")
    cid = torch.empty(r, kk, dtype=torch.int32, device=o.device)
    ent = torch.empty(r, kk, dtype=torch.float32, device=o.device)
    n_cl = torch.empty(r, dtype=torch.int32, device=o.device)
    kept = torch.empty(r, dtype=torch.float32, device=o.device)
    pb.launch("mts_dense_cull", o.device, o, d, t_max, cl_mbox, r, c, kk,
              cid, ent, n_cl, kept)
    dense_cull.launches += 1
    return cid, ent, n_cl, kept


dense_cull.launches = 0


def _cluster_lists_dense(pack, o, d, tmax):
    """Per-ray entry-sorted cluster lists (K3).  Returns (cids [R, kk]
    i32 (n_clusters = empty), entry [R, kk], ov: the overflow gate's
    statistics)."""
    c = pack.meta["n_clusters"]
    kk = min(K, c)
    cids, ent_k, n_cl, kept_max = dense_cull(o, d, tmax, pack.cl_mbox, c, kk)
    return cids, ent_k, {"n_cl": n_cl, "kk": kk, "kept_max_cl": kept_max}


def _overflow(ov, best_t):
    """Rays whose result may be wrong because the cull dropped clusters
    that enter before the best hit found (dropped ones enter at >= the
    kept maximum).  The dense cull has no supercluster level, so the
    reference's super-overflow term is always false here."""
    return (ov["n_cl"] > ov["kk"]) & (best_t > ov["kept_max_cl"])


# ---------------------------------------------------------------------------
# K4: pair hits
# ---------------------------------------------------------------------------

def _pair_slices(r, kk):
    """(ray range, slot) steps of the plain K4, slot-major."""
    step = max(PLAIN_PAIR_CHUNK // max(kk, 1), 1)
    return [(s, min(s + step, r), k) for k in range(kk) for s in range(0, r, step)]


def _pair_tests(o, d, t_max, cid, cl_tri, c, tc):
    """Moller-Trumbore of rays against their slot's cluster (clamped
    for empty slots): (valid [n], t, u, v, hit [n, tc])."""
    valid = cid < c
    rows = pb._cluster_rows(cl_tri, torch.clamp(cid, max=c - 1).long(), tc)
    ray = [o[:, a:a + 1] for a in range(3)] + [d[:, a:a + 1] for a in range(3)]
    return (valid, *mt_test(ray, rows, t_max[:, None]))


def pair_hit_closest_plain(o, d, t_max, cids, cl_tri, pad2prim, c, tc):
    """Plain K4, closest.  cids: [R, kk] from the cull.  Returns per slot
    (t [R, kk]: the closest hit's t in the slot's cluster, t_max without a
    hit, BIG for an empty slot; prim [R, kk] i32, -1 without a hit;
    u, v [R, kk], 0 without a hit)."""
    r, kk = cids.shape
    t_out = torch.empty(r, kk, dtype=torch.float32, device=o.device)
    p_out = torch.empty(r, kk, dtype=torch.int32, device=o.device)
    u_out = torch.empty(r, kk, dtype=torch.float32, device=o.device)
    v_out = torch.empty(r, kk, dtype=torch.float32, device=o.device)
    cols = torch.arange(tc, dtype=torch.int32, device=o.device)
    for s, e, k in _pair_slices(r, kk):
        cid = cids[s:e, k]
        tm = t_max[s:e]
        valid, t, u, v, hit = _pair_tests(o[s:e], d[s:e], tm, cid, cl_tri, c, tc)
        t = torch.where(hit, t, torch.inf)
        tmin = t.amin(dim=1)
        row = torch.where(t == tmin[:, None], cols, tc).amin(dim=1)
        found = tmin < tm
        rsel = row.clamp(max=tc - 1).long()
        prim = pad2prim[torch.clamp(cid, max=c - 1).long() * tc + rsel]
        t_out[s:e, k] = torch.where(valid, torch.where(found, tmin, tm), BIG)
        p_out[s:e, k] = torch.where(valid & found, prim, -1)
        u_out[s:e, k] = torch.where(valid & found, u.gather(1, rsel[:, None])[:, 0], 0.0)
        v_out[s:e, k] = torch.where(valid & found, v.gather(1, rsel[:, None])[:, 0], 0.0)
    return t_out, p_out, u_out, v_out


def pair_hit_any_plain(o, d, t_max, cids, cl_tri, c, tc):
    """Plain K4, any hit: occ [R, kk] bool, some triangle of the slot's
    cluster hit with t in (RAY_EPS, t_max), or t_max <= 0 (the reference's
    initial occlusion); False for an empty slot."""
    r, kk = cids.shape
    occ = torch.empty(r, kk, dtype=torch.bool, device=o.device)
    for s, e, k in _pair_slices(r, kk):
        tm = t_max[s:e]
        valid, _, _, _, hit = _pair_tests(o[s:e], d[s:e], tm, cids[s:e, k], cl_tri, c, tc)
        occ[s:e, k] = valid & ((tm <= 0.0) | hit.any(dim=1))
    return occ


def _pair_prepare(o, d, t_max, cids, cl_tri, c, tc):
    r = o.shape[0]
    native.check_tensors(
        o, ("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
        ("t_max", t_max, torch.float32, (r,)), ("cids", cids, torch.int32, None),
        ("cl_tri", cl_tri, torch.float32, (9, c * tc)),
    )
    if cids.ndim != 2 or cids.shape[0] != r:
        raise ValueError(f"cids must be [{r}, K], got {tuple(cids.shape)}")
    return tuple(x.contiguous() for x in (o, d, t_max, cids, cl_tri))


def pair_hit_closest(o, d, t_max, cids, cl_tri, pad2prim, c, tc):
    """K4, closest: see pair_hit_closest_plain."""
    o, d, t_max, cids, cl_tri = _pair_prepare(o, d, t_max, cids, cl_tri, c, tc)
    native.check_tensors(o, ("pad2prim", pad2prim, torch.int32, (c * tc,)))
    if o.device.type == "cpu":
        return pair_hit_closest_plain(o, d, t_max, cids, cl_tri, pad2prim, c, tc)
    r, kk = cids.shape
    outs = [torch.empty(r, kk, dtype=dt, device=o.device)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    pb.launch("mts_pair_closest", o.device, o, d, t_max, cids, cl_tri,
              pad2prim.contiguous(), r, kk, c, tc, cl_tri.shape[1], *outs)
    pair_hit_closest.launches += 1
    return tuple(outs)


def pair_hit_any(o, d, t_max, cids, cl_tri, c, tc):
    """K4, any hit: see pair_hit_any_plain."""
    o, d, t_max, cids, cl_tri = _pair_prepare(o, d, t_max, cids, cl_tri, c, tc)
    if o.device.type == "cpu":
        return pair_hit_any_plain(o, d, t_max, cids, cl_tri, c, tc)
    r, kk = cids.shape
    occ = torch.empty(r, kk, dtype=torch.int32, device=o.device)
    pb.launch("mts_pair_any", o.device, o, d, t_max, cids, cl_tri,
              r, kk, c, tc, cl_tri.shape[1], occ)
    pair_hit_any.launches += 1
    return occ > 0


pair_hit_closest.launches = 0
pair_hit_any.launches = 0


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def pair_closest(pack, o, d, t_max):
    """Closest hit via the pair pipeline.  Returns (t, prim, u, v): t =
    t_max (inf mapped to BIG) on a miss, prim = -1, u = v = 0 (K4 and K7
    leave u = v = 0 without a hit)."""
    _, t_max = pb.finite_tmax(t_max, o)
    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    cids, _, ov = _cluster_lists_dense(pack, o, d, t_max)
    t_rk, p_rk, u_rk, v_rk = pair_hit_closest(
        o, d, t_max, cids, pack.cl_tri, pack.cl_pad2prim, c, tc
    )
    # min over the slots; ties go to the nearest slot (pairs.py:1042)
    kk = t_rk.shape[1]
    slots = torch.arange(kk, device=o.device)
    t_min = t_rk.amin(dim=1, keepdim=True)
    kbest = torch.where(t_rk == t_min, slots, kk).amin(dim=1, keepdim=True)
    best_t = t_rk.gather(1, kbest)[:, 0]
    prim = p_rk.gather(1, kbest)[:, 0]
    u = u_rk.gather(1, kbest)[:, 0]
    v = v_rk.gather(1, kbest)[:, 0]
    best_t = torch.where(prim >= 0, best_t, t_max)

    overflow = torch.nonzero(_overflow(ov, best_t)).squeeze(1)
    pair_closest.rays += o.shape[0]
    pair_closest.overflow_rays += overflow.numel()
    if overflow.numel():
        ft, fp, fu, fv = pb.cluster_closest(
            pack, o[overflow], d[overflow], t_max[overflow]
        )
        use_fb = (fp >= 0) & (ft < best_t[overflow])
        best_t[overflow] = torch.where(use_fb, ft, best_t[overflow])
        prim[overflow] = torch.where(use_fb, fp, prim[overflow])
        u[overflow] = torch.where(use_fb, fu, u[overflow])
        v[overflow] = torch.where(use_fb, fv, v[overflow])
    return best_t, prim, u, v


def pair_any(pack, o, d, t_max):
    """Boolean occlusion via the pair pipeline."""
    _, t_max = pb.finite_tmax(t_max, o)
    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    cids, _, ov = _cluster_lists_dense(pack, o, d, t_max)
    occ = pair_hit_any(o, d, t_max, cids, pack.cl_tri, c, tc).any(dim=1)
    # an occluded ray is final; otherwise dropped clusters matter
    overflow = torch.nonzero(_overflow(ov, t_max) & ~occ).squeeze(1)
    pair_any.rays += o.shape[0]
    pair_any.overflow_rays += overflow.numel()
    if overflow.numel():
        occ[overflow] = pb.cluster_any(pack, o[overflow], d[overflow], t_max[overflow])
    return occ


for _fn in (pair_closest, pair_any):
    _fn.rays = 0
    _fn.overflow_rays = 0
