"""Pair traversal for big meshes (port of mitsuba_tpu/accel/pairs.py):

  1. exact per-ray culling into entry-sorted lists of the K nearest
     clusters, plus the overflow statistics.  Up to DENSE_C clusters the
     one-level dense cull (K3, `_dense_cull_kernel`) slab-tests every
     cluster box; past it the two-level cull (K5, `_cull_kernel`) keeps
     the KS nearest supercluster boxes and then the K nearest of their
     members;
  2. pair hits: each (ray, kept cluster) pair runs Moller-Trumbore over
     the cluster's Tc triangles; the min over the K slots, ties to the
     nearest slot, is the ray's hit.  The kernels test only the first
     `cl_cnt` triangles of a cluster (past them e2 = 0), copied from the
     triangle-major `cl_tri_rows` into shared memory.  Up to DENSE_C
     clusters one warp per ray takes its slots one by one, the lanes
     splitting each slot's triangles (K4, `_runs_kernel`); past it the
     lists are flattened into a cluster-sorted pair queue, and each warp
     walks its share of the queue run by run, copying each run's
     triangles once (K6, `_pair_kernel`);
  3. rays whose lists overflowed (more than KS supers or K clusters hit,
     and no hit before the kept horizon) re-run through the per-ray
     cluster traversal (K7/K8 or K9/K10, accel/pallas_bvh.py).

The reference's queue BUDGET and run lists exist to give the TPU static
shapes and are not ported: the port's queue holds every slot, so no pair
is ever dropped and the reference's "dropped" overflow class cannot occur,
and K6 writes its results back to [R, K] order by index.

Each kernel wrapper launches its CUDA kernel (K3/K4: csrc/cluster_hit.cu;
K5/K6: csrc/cluster_stream.cu) for tensors on a GPU and runs its plain
PyTorch version for tensors on the CPU; there is no fallback from one to
the other.  Each counts its kernel launches in `.launches`.
`pair_closest` and `pair_any` count the rays they were given in `.rays`
and those that took the fallback in `.overflow_rays`.
"""

from __future__ import annotations

import torch

from mitsuba_tpu_torch import native
from mitsuba_tpu_torch.accel import pallas_bvh as pb
from mitsuba_tpu_torch.accel.pallas_kernels import mt_test

BIG = pb.BIG
# clusters kept per ray, and (two-level cull) superclusters kept per ray;
# a test or a smoke run may lower them to force the overflow fallback, as
# the reference's tests do
K = 3
KS = 8
# the reference's dense-cull bound (pairs.py:192-193: its VMEM budget at
# 512-ray blocks); above it the reference runs K5/K6
DENSE_C = 1890
# (ray, slot) pairs per step of the plain K4/K6
PLAIN_PAIR_CHUNK = 1 << 16


# ---------------------------------------------------------------------------
# K3: dense cull
# ---------------------------------------------------------------------------

def _cull_slab(lo, hi, o, inv, t_max):
    """The cull's slab in the reference kernels' order: per axis
    (box - o) * inv, tn = max(tn, min(t0, t1)) and tf = min(tf, max(t0,
    t1)) folded from -BIG / BIG.  lo, hi: [..., 3] boxes broadcasting
    against [n, B]; o, inv: [n, 3]; t_max: [n].  Returns (entry, hit)."""
    tn = torch.full((), -BIG, dtype=torch.float32, device=o.device)
    tf = torch.full((), BIG, dtype=torch.float32, device=o.device)
    for a in range(3):
        t0 = (lo[..., a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        t1 = (hi[..., a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    en = torch.clamp(tn, min=0.0)
    return en, (tf >= en) & (tn < t_max[:, None])


def _k_smallest(key, k):
    """The k smallest keys per row, ascending, ties by index (a stable
    sort's order: the reference's k-pass argmin).  Returns (val, idx)."""
    val, idx = torch.sort(key, dim=1, stable=True)
    return val[:, :k], idx[:, :k]


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
    for s, e in pb._chunks(r, c):
        en, hit = _cull_slab(boxes[None, :, 0:3], boxes[None, :, 3:6], o[s:e], inv[s:e], t_max[s:e])
        val, idx = _k_smallest(torch.where(hit, en, BIG), kk)
        ent[s:e] = val
        cid[s:e] = torch.where(val < BIG, idx, c).to(torch.int32)
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
    pb.check_aligned(("cl_mbox", cl_mbox), align=8)
    max_c, max_k, _ = pb.kernel_limits()
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


# ---------------------------------------------------------------------------
# K5: two-level cull
# ---------------------------------------------------------------------------

def two_level_cull_plain(o, d, t_max, cl_sup, cl_mbox, s, c, ks, kk):
    """Plain K5.  o, d: [R, 3]; t_max: [R] finite; cl_sup: [8, Sp] super
    boxes (the first s are real); cl_mbox: [Sp, G*6] member boxes.
    Level 1 keeps the ks supers of smallest entry; level 2 slab-tests
    their members (cluster ids < c) in candidate order j*G + m and keeps
    the kk of smallest entry, ties to the earlier candidate.

    Returns (cid [R, kk] i32, c = empty; entry [R, kk] ascending, BIG =
    empty; n_sup [R] i32: supers hit; kept_max_sup [R]: the ks-th kept
    super entry; n_cl [R] i32: member clusters of kept supers hit;
    kept_max_cl [R]: the kk-th entry)."""
    r, sp = o.shape[0], cl_sup.shape[1]
    g = cl_mbox.shape[1] // 6
    inv = pb.safe_inv(d)
    sup_lo, sup_hi = cl_sup[0:3].T[None], cl_sup[3:6].T[None]  # [1, Sp, 3]
    real = torch.arange(sp, device=o.device)[None] < s  # padded supers are inverted
    members = torch.arange(g, dtype=torch.int32, device=o.device)
    outs = [torch.empty(r, kk, dtype=torch.int32, device=o.device),
            torch.empty(r, kk, dtype=torch.float32, device=o.device),
            torch.empty(r, dtype=torch.int32, device=o.device),
            torch.empty(r, dtype=torch.float32, device=o.device),
            torch.empty(r, dtype=torch.int32, device=o.device),
            torch.empty(r, dtype=torch.float32, device=o.device)]
    for s0, e0 in pb._chunks(r, sp + ks * g):
        oo, ii, tm = o[s0:e0], inv[s0:e0], t_max[s0:e0]
        # level 1
        en, hit = _cull_slab(sup_lo, sup_hi, oo, ii, tm)
        hit = hit & real
        val_s, sid = _k_smallest(torch.where(hit, en, BIG), ks)
        outs[2][s0:e0] = hit.sum(dim=1, dtype=torch.int32)
        outs[3][s0:e0] = val_s[:, ks - 1]
        # level 2: the kept supers' member boxes, [n, ks*G]
        mb = cl_mbox[sid].reshape(e0 - s0, ks * g, 6)
        cand = (sid[:, :, None].to(torch.int32) * g + members).reshape(e0 - s0, ks * g)
        ok = (val_s < BIG).repeat_interleave(g, dim=1) & (cand < c)
        en, hit = _cull_slab(mb[..., 0:3], mb[..., 3:6], oo, ii, tm)
        hit = hit & ok
        val_c, pos = _k_smallest(torch.where(hit, en, BIG), kk)
        outs[0][s0:e0] = torch.where(val_c < BIG, cand.gather(1, pos), c)
        outs[1][s0:e0] = val_c
        outs[4][s0:e0] = hit.sum(dim=1, dtype=torch.int32)
        outs[5][s0:e0] = val_c[:, kk - 1]
    return tuple(outs)


def two_level_cull(o, d, t_max, cl_sup, cl_mbox, s, c, ks, kk):
    """K5: see two_level_cull_plain."""
    r = o.shape[0]
    native.check_tensors(
        o, ("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
        ("t_max", t_max, torch.float32, (r,)),
        ("cl_sup", cl_sup, torch.float32, None),
        ("cl_mbox", cl_mbox, torch.float32, None),
    )
    sp = cl_sup.shape[1]
    g = cl_mbox.shape[1] // 6
    if (cl_sup.ndim != 2 or cl_sup.shape[0] != 8 or cl_mbox.shape != (sp, g * 6)
            or not 1 <= s <= sp or c > s * g or not 1 <= ks <= s or not 1 <= kk <= ks * g):
        raise ValueError(f"cl_sup {tuple(cl_sup.shape)} / cl_mbox {tuple(cl_mbox.shape)} / "
                         f"ks {ks} / kk {kk} do not fit {s} supers of {c} clusters")
    o, d, t_max, cl_sup, cl_mbox = (x.contiguous() for x in (o, d, t_max, cl_sup, cl_mbox))
    if o.device.type == "cpu":
        return two_level_cull_plain(o, d, t_max, cl_sup, cl_mbox, s, c, ks, kk)
    pb.check_aligned(("cl_mbox", cl_mbox), align=8)
    max_s, max_ks, max_k, _ = pb.stream_limits()
    if s > max_s or ks > max_ks or kk > max_k:
        raise ValueError(f"the two-level cull takes at most {max_s} supers, KS <= {max_ks} "
                         f"and K <= {max_k}, got {s}, {ks} and {kk}")
    outs = [torch.empty(r, kk, dtype=torch.int32, device=o.device),
            torch.empty(r, kk, dtype=torch.float32, device=o.device)]
    outs += [torch.empty(r, dtype=dt, device=o.device)
             for dt in (torch.int32, torch.float32, torch.int32, torch.float32)]
    pb.launch_stream("mts_two_level_cull", o.device, o, d, t_max, cl_sup, cl_mbox,
                     r, sp, s, c, g, ks, kk, *outs)
    two_level_cull.launches += 1
    return tuple(outs)


two_level_cull.launches = 0


def _cluster_lists(pack, o, d, tmax):
    """Per-ray entry-sorted cluster lists: K3 up to DENSE_C clusters, K5
    past it (pairs.py:969).  Returns (cids [R, kk] i32 (n_clusters =
    empty), entry [R, kk], ov: the overflow gate's statistics)."""
    c = pack.meta["n_clusters"]
    if c <= DENSE_C:
        return _cluster_lists_dense(pack, o, d, tmax)
    s = pack.meta["n_supers"]
    ks = min(KS, s)
    kk = min(K, ks * pack.meta["cluster_super_g"])
    cids, ent_k, n_sup, kept_sup, n_cl, kept_cl = two_level_cull(
        o, d, tmax, pack.cl_sup, pack.cl_mbox, s, c, ks, kk
    )
    return cids, ent_k, {"n_sup": n_sup, "ks": ks, "kept_max_sup": kept_sup,
                         "n_cl": n_cl, "kk": kk, "kept_max_cl": kept_cl}


def _overflow(ov, best_t):
    """Rays whose result may be wrong because the cull dropped supers or
    clusters that enter before the best hit found (dropped ones enter at
    >= the kept maximum).  The dense cull has no super level."""
    over = (ov["n_cl"] > ov["kk"]) & (best_t > ov["kept_max_cl"])
    if "n_sup" in ov:
        over = over | ((ov["n_sup"] > ov["ks"]) & (best_t > ov["kept_max_sup"]))
    return over


# ---------------------------------------------------------------------------
# K4: pair hits
# ---------------------------------------------------------------------------

def _pair_slices(r, kk):
    """(ray range, slot) steps of the plain K4, slot-major."""
    step = max(PLAIN_PAIR_CHUNK // max(kk, 1), 1)
    return [(s, min(s + step, r), k) for k in range(kk) for s in range(0, r, step)]


def _pair_tests(o, d, t_max, cid, cl_tri, c, tc):
    """Moller-Trumbore of rays against their pair's cluster (clamped
    for empty slots): (valid [n], t, u, v, hit [n, tc])."""
    valid = cid < c
    rows = pb._cluster_rows(cl_tri, torch.clamp(cid, max=c - 1).long(), tc)
    ray = [o[:, a:a + 1] for a in range(3)] + [d[:, a:a + 1] for a in range(3)]
    return (valid, *mt_test(ray, rows, t_max[:, None]))


def _closest_pairs(o, d, t_max, cid, cl_tri, pad2prim, c, tc):
    """The closest hit of n (ray, cluster) pairs: (t, prim, u, v) [n] as
    the plain K4/K6 return them per slot."""
    valid, t, u, v, hit = _pair_tests(o, d, t_max, cid, cl_tri, c, tc)
    cols = torch.arange(tc, dtype=torch.int32, device=o.device)
    t = torch.where(hit, t, torch.inf)
    tmin = t.amin(dim=1)
    row = torch.where(t == tmin[:, None], cols, tc).amin(dim=1)
    found = tmin < t_max
    rsel = row.clamp(max=tc - 1).long()
    prim = pad2prim[torch.clamp(cid, max=c - 1).long() * tc + rsel]
    return (torch.where(valid, torch.where(found, tmin, t_max), BIG),
            torch.where(valid & found, prim, -1),
            torch.where(valid & found, u.gather(1, rsel[:, None])[:, 0], 0.0),
            torch.where(valid & found, v.gather(1, rsel[:, None])[:, 0], 0.0))


def _any_pairs(o, d, t_max, cid, cl_tri, c, tc):
    """Occlusion of n (ray, cluster) pairs [n] as the plain K4/K6 return
    it per slot."""
    valid, _, _, _, hit = _pair_tests(o, d, t_max, cid, cl_tri, c, tc)
    return valid & ((t_max <= 0.0) | hit.any(dim=1))


def pair_hit_closest_plain(o, d, t_max, cids, cl_tri, pad2prim, c, tc):
    """Plain K4, closest.  cids: [R, kk] from the cull.  Returns per slot
    (t [R, kk]: the closest hit's t in the slot's cluster, t_max without a
    hit, BIG for an empty slot; prim [R, kk] i32, -1 without a hit;
    u, v [R, kk], 0 without a hit)."""
    r, kk = cids.shape
    outs = [torch.empty(r, kk, dtype=dt, device=o.device)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    for s, e, k in _pair_slices(r, kk):
        res = _closest_pairs(o[s:e], d[s:e], t_max[s:e], cids[s:e, k], cl_tri, pad2prim, c, tc)
        for out, x in zip(outs, res):
            out[s:e, k] = x
    return tuple(outs)


def pair_hit_any_plain(o, d, t_max, cids, cl_tri, c, tc):
    """Plain K4, any hit: occ [R, kk] bool, some triangle of the slot's
    cluster hit with t in (RAY_EPS, t_max), or t_max <= 0 (the reference's
    initial occlusion); False for an empty slot."""
    r, kk = cids.shape
    occ = torch.empty(r, kk, dtype=torch.bool, device=o.device)
    for s, e, k in _pair_slices(r, kk):
        occ[s:e, k] = _any_pairs(o[s:e], d[s:e], t_max[s:e], cids[s:e, k], cl_tri, c, tc)
    return occ


def _pair_prepare(o, d, t_max, cids, cl_tri, c, tc, cl_cnt, cl_tri_rows):
    r = o.shape[0]
    native.check_tensors(
        o, ("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
        ("t_max", t_max, torch.float32, (r,)), ("cids", cids, torch.int32, None),
        ("cl_tri", cl_tri, torch.float32, (9, c * tc)), ("cl_cnt", cl_cnt, torch.int32, (c,)),
        ("cl_tri_rows", cl_tri_rows, torch.float32, (c * tc, 9)),
    )
    if cids.ndim != 2 or cids.shape[0] != r:
        raise ValueError(f"cids must be [{r}, K], got {tuple(cids.shape)}")
    return tuple(x.contiguous() for x in (o, d, t_max, cids, cl_tri, cl_cnt, cl_tri_rows))


def _pair_check(cids, cl_tri_rows, tc):
    _rows_check(cl_tri_rows, tc)
    _, max_k, _ = pb.kernel_limits()
    if not 1 <= cids.shape[1] <= max_k:
        raise ValueError(f"the pair kernel takes 1 <= K <= {max_k}, got {cids.shape[1]}")


def pair_hit_closest(o, d, t_max, cids, cl_tri, pad2prim, c, tc, cl_cnt, cl_tri_rows):
    """K4, closest: see pair_hit_closest_plain.  cl_cnt [C] i32 and
    cl_tri_rows [C*Tc, 9] as window_hit_closest takes them: the kernel
    tests only each cluster's first cl_cnt columns, read from
    cl_tri_rows; the plain version tests all of cl_tri."""
    o, d, t_max, cids, cl_tri, cl_cnt, cl_tri_rows = _pair_prepare(
        o, d, t_max, cids, cl_tri, c, tc, cl_cnt, cl_tri_rows)
    native.check_tensors(o, ("pad2prim", pad2prim, torch.int32, (c * tc,)))
    if o.device.type == "cpu":
        return pair_hit_closest_plain(o, d, t_max, cids, cl_tri, pad2prim, c, tc)
    _pair_check(cids, cl_tri_rows, tc)
    r, kk = cids.shape
    outs = [torch.empty(r, kk, dtype=dt, device=o.device)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    pb.launch("mts_pair_closest", o.device, o, d, t_max, cids, cl_tri_rows, cl_cnt,
              pad2prim.contiguous(), r, kk, c, tc, *outs)
    pair_hit_closest.launches += 1
    return tuple(outs)


def pair_hit_any(o, d, t_max, cids, cl_tri, c, tc, cl_cnt, cl_tri_rows):
    """K4, any hit: see pair_hit_any_plain (cl_cnt, cl_tri_rows as
    pair_hit_closest)."""
    o, d, t_max, cids, cl_tri, cl_cnt, cl_tri_rows = _pair_prepare(
        o, d, t_max, cids, cl_tri, c, tc, cl_cnt, cl_tri_rows)
    if o.device.type == "cpu":
        return pair_hit_any_plain(o, d, t_max, cids, cl_tri, c, tc)
    _pair_check(cids, cl_tri_rows, tc)
    r, kk = cids.shape
    occ = torch.empty(r, kk, dtype=torch.int32, device=o.device)
    pb.launch("mts_pair_any", o.device, o, d, t_max, cids, cl_tri_rows, cl_cnt,
              r, kk, c, tc, occ)
    pair_hit_any.launches += 1
    return occ > 0


pair_hit_closest.launches = 0
pair_hit_any.launches = 0


# ---------------------------------------------------------------------------
# K6: window pair hits over the cluster-sorted pair queue
# ---------------------------------------------------------------------------

def pair_queue(cids):
    """The cluster-sorted pair queue of [R, kk] lists (pairs.py:488-567,
    without the budget): (cid_q [R*kk] i32 ascending, empty slots (cid
    = n_clusters) last; pair_q [R*kk] i32, the flat index ray*kk + slot
    of each entry).  Every slot is in the queue exactly once."""
    cid_q, pair_q = torch.sort(cids.reshape(-1), stable=True)
    return cid_q.contiguous(), pair_q.to(torch.int32)


def _queue_chunks(n):
    return [(s, min(s + PLAIN_PAIR_CHUNK, n)) for s in range(0, n, PLAIN_PAIR_CHUNK)]


def window_hit_closest_plain(o, d, t_max, cid_q, pair_q, kk, cl_tri, pad2prim, c, tc):
    """Plain K6, closest: each queue entry's pair as in K4, written to
    its slot.  Returns (t, prim, u, v) [R, kk] as pair_hit_closest_plain."""
    r = o.shape[0]
    outs = [torch.empty(r * kk, dtype=dt, device=o.device)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    for s, e in _queue_chunks(cid_q.shape[0]):
        pair = pair_q[s:e].long()
        ray = pair // kk
        res = _closest_pairs(o[ray], d[ray], t_max[ray], cid_q[s:e], cl_tri, pad2prim, c, tc)
        for out, x in zip(outs, res):
            out[pair] = x
    return tuple(x.reshape(r, kk) for x in outs)


def window_hit_any_plain(o, d, t_max, cid_q, pair_q, kk, cl_tri, c, tc):
    """Plain K6, any hit: occ [R, kk] as pair_hit_any_plain."""
    r = o.shape[0]
    occ = torch.empty(r * kk, dtype=torch.bool, device=o.device)
    for s, e in _queue_chunks(cid_q.shape[0]):
        pair = pair_q[s:e].long()
        ray = pair // kk
        occ[pair] = _any_pairs(o[ray], d[ray], t_max[ray], cid_q[s:e], cl_tri, c, tc)
    return occ.reshape(r, kk)


def _window_prepare(o, d, t_max, cid_q, pair_q, kk, cl_tri, c, tc, cl_cnt, cl_tri_rows):
    r = o.shape[0]
    native.check_tensors(
        o, ("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
        ("t_max", t_max, torch.float32, (r,)),
        ("cid_q", cid_q, torch.int32, (r * kk,)), ("pair_q", pair_q, torch.int32, (r * kk,)),
        ("cl_tri", cl_tri, torch.float32, (9, c * tc)), ("cl_cnt", cl_cnt, torch.int32, (c,)),
        ("cl_tri_rows", cl_tri_rows, torch.float32, (c * tc, 9)),
    )
    return tuple(x.contiguous() for x in (o, d, t_max, cid_q, pair_q, cl_tri, cl_cnt, cl_tri_rows))


def _rows_check(cl_tri_rows, tc):
    pb.check_aligned(("cl_tri_rows", cl_tri_rows))
    if tc % 4:
        raise ValueError(f"the pair kernels take Tc a multiple of 4, got {tc}")


def window_hit_closest(o, d, t_max, cid_q, pair_q, kk, cl_tri, pad2prim, c, tc, cl_cnt,
                       cl_tri_rows):
    """K6, closest: see window_hit_closest_plain.  cl_cnt [C] i32: the
    columns of each cluster that can hold a hit (scene/builder.py
    cluster_columns); the kernel tests only those, the plain version all.
    cl_tri_rows [C*Tc, 9]: cl_tri transposed (_tri_rows), which the
    kernel reads."""
    o, d, t_max, cid_q, pair_q, cl_tri, cl_cnt, cl_tri_rows = _window_prepare(
        o, d, t_max, cid_q, pair_q, kk, cl_tri, c, tc, cl_cnt, cl_tri_rows)
    native.check_tensors(o, ("pad2prim", pad2prim, torch.int32, (c * tc,)))
    if o.device.type == "cpu":
        return window_hit_closest_plain(o, d, t_max, cid_q, pair_q, kk, cl_tri, pad2prim, c, tc)
    _rows_check(cl_tri_rows, tc)
    r = o.shape[0]
    outs = [torch.empty(r, kk, dtype=dt, device=o.device)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    pb.launch_stream("mts_window_closest", o.device, o, d, t_max, cid_q, pair_q, r * kk, kk,
                     cl_tri_rows, cl_cnt, pad2prim.contiguous(), c, tc, *outs)
    window_hit_closest.launches += 1
    return tuple(outs)


def window_hit_any(o, d, t_max, cid_q, pair_q, kk, cl_tri, c, tc, cl_cnt, cl_tri_rows):
    """K6, any hit: see window_hit_any_plain (cl_cnt, cl_tri_rows as
    window_hit_closest)."""
    o, d, t_max, cid_q, pair_q, cl_tri, cl_cnt, cl_tri_rows = _window_prepare(
        o, d, t_max, cid_q, pair_q, kk, cl_tri, c, tc, cl_cnt, cl_tri_rows)
    if o.device.type == "cpu":
        return window_hit_any_plain(o, d, t_max, cid_q, pair_q, kk, cl_tri, c, tc)
    _rows_check(cl_tri_rows, tc)
    r = o.shape[0]
    occ = torch.empty(r, kk, dtype=torch.int32, device=o.device)
    pb.launch_stream("mts_window_any", o.device, o, d, t_max, cid_q, pair_q, r * kk, kk,
                     cl_tri_rows, cl_cnt, c, tc, occ)
    window_hit_any.launches += 1
    return occ > 0


def _tri_rows(pack):
    """The pair kernels' copy of the pack's cl_tri with each triangle's
    nine floats together, [C*Tc, 9] (2.5 MB at 773 clusters, 45 MB at
    9,856): a cluster's first cl_cnt triangles are one block, one bulk
    copy (K4 per (ray, slot), K6 per run; nine per-row copies of cl_tri
    were 3-16 % slower in K6 on an H100, PERF.md).  Made on the pack's
    first pair_closest or pair_any call (K4 or K6) and kept in it, so
    that only packs the pair pipeline runs on hold it."""
    if "cl_tri_rows" not in pack.arrays:
        pack.arrays["cl_tri_rows"] = pack.cl_tri.T.contiguous()
    return pack.arrays["cl_tri_rows"]


window_hit_closest.launches = 0
window_hit_any.launches = 0


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def pair_closest(pack, o, d, t_max):
    """Closest hit via the pair pipeline.  Returns (t, prim, u, v): t =
    t_max (inf mapped to BIG) on a miss, prim = -1, u = v = 0 (K4 and K7
    leave u = v = 0 without a hit).  K4 up to DENSE_C clusters, K6 past
    it (pairs.py:996)."""
    _, t_max = pb.finite_tmax(t_max, o)
    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    cids, _, ov = _cluster_lists(pack, o, d, t_max)
    if c <= DENSE_C:
        t_rk, p_rk, u_rk, v_rk = pair_hit_closest(
            o, d, t_max, cids, pack.cl_tri, pack.cl_pad2prim, c, tc, pack.cl_cnt, _tri_rows(pack)
        )
    else:
        t_rk, p_rk, u_rk, v_rk = window_hit_closest(
            o, d, t_max, *pair_queue(cids), cids.shape[1], pack.cl_tri,
            pack.cl_pad2prim, c, tc, pack.cl_cnt, _tri_rows(pack)
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
    cids, _, ov = _cluster_lists(pack, o, d, t_max)
    if c <= DENSE_C:
        occ = pair_hit_any(o, d, t_max, cids, pack.cl_tri, c, tc, pack.cl_cnt, _tri_rows(pack))
    else:
        occ = window_hit_any(o, d, t_max, *pair_queue(cids), cids.shape[1], pack.cl_tri, c, tc,
                             pack.cl_cnt, _tri_rows(pack))
    occ = occ.any(dim=1)
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
