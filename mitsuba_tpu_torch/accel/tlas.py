"""Two-level instancing (port of mitsuba_tpu/accel/tlas.py): a TLAS over
the instances' world boxes, spliced with one copy of its group's BLAS per
instance into one threaded node array, and the pair route that sends
template-space rays through each group's own cluster tables.

The reference Mitsuba walks a kd-tree per instance with a stack
(include/mitsuba/render/shapegroup.h:34, 63-76; src/shapes/instance.cpp
rayIntersect: the ray into instance space, then the group's tree).  A
stackless skip-link walk cannot re-enter a shared subtree, so the splice
copies NODES per instance, with world-space boxes baked per instance,
while the TRIANGLES stay shared in local space: a leaf visit fetches its
instance's world -> local affine and re-bases the ray, its direction left
unnormalized so that t carries over.

Node row layout [N, 10] f32: lo(3) hi(3) first count skip inst_id;
internal rows have count 0 and inst_id -1.  `first` indexes inst_tri9
(local triangles in BLAS leaf order), and inst_tri2prim maps those rows
back to the pack's triangle ids for the shading attributes.  `first` and
`skip` are float32, exact below 2^24 rows (ROADMAP C7).

Two routes, as the reference chooses them (accel/intersect.py
`_use_inst_pairs`):

* the loop path, `inst_closest` / `inst_any`: every ray walks the splice
  in lockstep, one step a loop iteration (a host sync each, as
  accel/intersect.py `_bvh_traverse`);
* the pair path, `inst_closest_pairs` / `inst_any_pairs`: each ray's
  K_INST nearest instance boxes by slab entry (`_inst_lists`), then per
  round and group every lane re-based into its instance's frame and the
  whole batch sent through accel/pairs.py `pair_closest` / `pair_any` on
  the group's cluster tables, with t_max 0 on the lanes of other groups
  (K3/K4 and the K7/K8 fallback on a GPU, their plain versions on the
  CPU).  Rays that meet more than K_INST instance boxes are finished by
  the loop path.

`build_instance_accel` runs on the host in numpy, the rest in torch
operations on the pack's device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from mitsuba_tpu_torch.accel import pairs
from mitsuba_tpu_torch.accel.bvh import LEAF_SIZE, build_bvh
from mitsuba_tpu_torch.accel.clusters import pack_clusters
from mitsuba_tpu_torch.accel.pallas_bvh import safe_inv

# instance boxes kept per ray by the pair path
K_INST = int(os.environ.get("MTS_TLAS_K", 4))
_CULL_R = 16384  # rays per tile of the instance cull
_CULL_I = 512  # instance boxes per step of the cull
_BIG = 1e30


def _world_box(lo, hi, m):
    """World AABBs of local AABBs [K, 3] under the affine m (3x4 or 4x4):
    the box of the 8 transformed corners (loose under rotation, always
    conservative)."""
    corners = []
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                c = np.stack([(hi if cx else lo)[:, 0], (hi if cy else lo)[:, 1],
                              (hi if cz else lo)[:, 2]], axis=-1)
                corners.append(c @ m[:3, :3].T + m[:3, 3])
    corners = np.stack(corners, axis=0)  # [8, K, 3]
    return corners.min(axis=0), corners.max(axis=0)


def build_instance_accel(groups, tri_v0, tri_e1, tri_e2):
    """groups: [(row_lo, row_hi, [Transform, ...])], each group's template
    rows (the pack's triangle ids, local space) and its instances' world
    transforms.  Returns (arrays, meta) with the reference's names
    (tlas.py:52-269): the splice inst_nodes, inst_tri9 / inst_tri2prim
    with a far triangle last, the per-instance inst_inv (world -> local,
    9 linear + 3 translation), inst_nrm (the normals' local -> world
    matrix) and inst_fwd (the tangents'), the pair path's inst_wbox /
    inst_group (padded to a multiple of 8 with boxes at 1e30) and each
    group's cluster tables ig{g}_* over its BLAS-ordered rows plus
    LEAF_SIZE far rows; meta has_instances, n_instances, inst_groups
    ((row_lo, count, cluster meta items or None) per group) and
    inst_pairs_ok (every group has cluster tables)."""
    blas = []  # per group: (bvh, tri9 rows, their triangle ids)
    g_of_inst, xf_of_inst = [], []
    for gi, (lo_r, hi_r, xfs) in enumerate(groups):
        v0, e1, e2 = tri_v0[lo_r:hi_r], tri_e1[lo_r:hi_r], tri_e2[lo_r:hi_r]
        blo = np.minimum(v0, np.minimum(v0 + e1, v0 + e2))
        bhi = np.maximum(v0, np.maximum(v0 + e1, v0 + e2))
        bvh = build_bvh(v0 + (e1 + e2) / 3.0, blo, bhi)
        order = bvh.order
        tri9 = np.concatenate([v0[order], e1[order], e2[order]], axis=-1).astype(np.float32)
        blas.append((bvh, tri9, (lo_r + order).astype(np.int32)))
        for t in xfs:
            g_of_inst.append(gi)
            xf_of_inst.append(np.asarray(t.m, np.float64))

    n_inst = len(g_of_inst)
    tri_base, node_count = [], []
    base = 0
    for bvh, tri9, _ in blas:
        tri_base.append(base)
        base += len(tri9)
        node_count.append(len(bvh.skip))
    tri9_all = np.concatenate([b[1] for b in blas]) if blas else np.zeros((1, 9), np.float32)
    t2p_all = np.concatenate([b[2] for b in blas]) if blas else np.zeros(1, np.int32)
    # a far triangle for the masked slots of a leaf
    pad = np.full((1, 9), 1e30, np.float32)
    pad[0, 3:] = 0.0
    tri9_all = np.concatenate([tri9_all, pad])
    t2p_all = np.concatenate([t2p_all, np.zeros(1, np.int32)])

    # the instances' world boxes from their group's BLAS root box
    w_lo = np.zeros((n_inst, 3))
    w_hi = np.zeros((n_inst, 3))
    inst_inv = np.zeros((n_inst, 12), np.float32)
    inst_nrm = np.zeros((n_inst, 9), np.float32)
    inst_fwd = np.zeros((n_inst, 9), np.float32)
    for i in range(n_inst):
        bvh = blas[g_of_inst[i]][0]
        m = xf_of_inst[i]
        lo_i, hi_i = _world_box(bvh.lo[:1], bvh.hi[:1], m)
        w_lo[i], w_hi[i] = lo_i[0], hi_i[0]
        inv = np.linalg.inv(m)
        inst_inv[i, :9] = inv[:3, :3].reshape(-1)
        inst_inv[i, 9:] = inv[:3, 3]
        inst_nrm[i] = inv[:3, :3].T.reshape(-1)  # normals: the inverse transpose
        inst_fwd[i] = m[:3, :3].reshape(-1)  # tangents: forward

    tlas = build_bvh(0.5 * (w_lo + w_hi), w_lo, w_hi)
    n_tlas = len(tlas.skip)

    # rows of each TLAS subtree (threaded DFS: the children of internal
    # node i are i + 1 and skip[i + 1]), so that the splice is emitted in
    # one pass
    size = np.zeros(n_tlas, np.int64)

    def subtree_size(i):
        if size[i]:
            return size[i]
        if tlas.count[i] > 0:
            s = 1 + sum(node_count[g_of_inst[int(tlas.order[tlas.first[i] + j])]]
                        for j in range(tlas.count[i]))
        else:
            c1 = i + 1
            s = 1 + subtree_size(c1) + subtree_size(int(tlas.skip[c1]))
        size[i] = s
        return s

    old_lim = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_lim, 10_000))
    try:
        total = subtree_size(0) if n_tlas else 0
        rows = np.zeros((max(total, 1), 10), np.float32)
        cursor = [0]

        def emit_instance(inst, exit_idx):
            gi = g_of_inst[inst]
            bvh = blas[gi][0]
            nb = node_count[gi]
            start = cursor[0]
            lo_w, hi_w = _world_box(bvh.lo, bvh.hi, xf_of_inst[inst])
            rows[start:start + nb, 0:3] = lo_w
            rows[start:start + nb, 3:6] = hi_w
            rows[start:start + nb, 6] = np.where(bvh.count > 0, tri_base[gi] + bvh.first,
                                                 0).astype(np.float32)
            rows[start:start + nb, 7] = bvh.count
            rows[start:start + nb, 8] = np.where(bvh.skip >= nb, exit_idx,
                                                 start + bvh.skip).astype(np.float32)
            rows[start:start + nb, 9] = np.where(bvh.count > 0, float(inst), -1.0)
            cursor[0] += nb

        def emit_tlas(i, exit_idx):
            start = cursor[0]
            cursor[0] += 1
            if tlas.count[i] > 0:
                insts = [int(tlas.order[tlas.first[i] + j]) for j in range(tlas.count[i])]
                for k, inst in enumerate(insts):
                    nxt = (exit_idx if k == len(insts) - 1
                           else cursor[0] + node_count[g_of_inst[inst]])
                    emit_instance(inst, nxt)
            else:
                c1 = i + 1
                c2 = int(tlas.skip[c1])
                emit_tlas(c1, cursor[0] + int(size[c1]))
                emit_tlas(c2, exit_idx)
            rows[start, 0:3] = tlas.lo[i]
            rows[start, 3:6] = tlas.hi[i]
            rows[start, 6:8] = 0.0
            rows[start, 8] = exit_idx
            rows[start, 9] = -1.0

        if n_tlas:
            emit_tlas(0, total)
    finally:
        sys.setrecursionlimit(old_lim)

    arrays = {
        "inst_nodes": rows,
        "inst_tri9": tri9_all,
        "inst_tri2prim": t2p_all,
        "inst_inv": inst_inv,
        "inst_nrm": inst_nrm,
        "inst_fwd": inst_fwd,
    }
    meta = {"has_instances": n_inst > 0, "n_instances": n_inst}

    # the pair path's tables: the instance boxes, and per group cluster
    # tables over its local BLAS-ordered rows (tlas.py:214-268)
    ip = max(((n_inst + 7) // 8) * 8, 8)
    wbox = np.full((ip, 6), 1e30, np.float32)  # point boxes: never hit
    wbox[:n_inst, 0:3] = w_lo
    wbox[:n_inst, 3:6] = w_hi
    arrays["inst_wbox"] = wbox
    grp = np.zeros(ip, np.int32)
    grp[:n_inst] = np.asarray(g_of_inst, np.int32)
    arrays["inst_group"] = grp
    groups_meta = []
    pairs_ok = n_inst > 0
    for gi, (lo_r, hi_r, _) in enumerate(groups):
        count = hi_r - lo_r
        bvh, tri9_g, t2p_g = blas[gi]
        # LEAF_SIZE far rows; row `count` is the dummy slot of the tiles
        padv = np.full((LEAF_SIZE, 3), 1e30, np.float32)
        padz = np.zeros((LEAF_SIZE, 3), np.float32)
        v0p = np.concatenate([tri9_g[:, 0:3], padv])
        e1p = np.concatenate([tri9_g[:, 3:6], padz])
        e2p = np.concatenate([tri9_g[:, 6:9], padz])
        cl = pack_clusters(bvh, v0p, e1p, e2p, count)
        if cl is None:
            groups_meta.append((int(lo_r), int(count), None))
            pairs_ok = False
            continue
        g_arrays, g_meta = cl
        for k, v in g_arrays.items():
            arrays[f"ig{gi}_{k}"] = v
        arrays[f"ig{gi}_tri_v0"] = v0p
        arrays[f"ig{gi}_tri_e1"] = e1p
        arrays[f"ig{gi}_tri_e2"] = e2p
        # BLAS-order row -> the pack's triangle id (the far rows -1)
        arrays[f"ig{gi}_t2p"] = np.concatenate([t2p_g, np.full(LEAF_SIZE, -1, np.int32)])
        groups_meta.append((int(lo_r), int(count), tuple(sorted(g_meta.items()))))
    meta["inst_groups"] = tuple(groups_meta)
    meta["inst_pairs_ok"] = pairs_ok
    return arrays, meta


def matvec(rows9, v):
    """Per-lane 3x3 matrices (rows [R, 9], row-major) times vectors [R, 3]."""
    lin = rows9.reshape(-1, 3, 3)
    return lin[:, :, 0] * v[:, 0:1] + lin[:, :, 1] * v[:, 1:2] + lin[:, :, 2] * v[:, 2:3]


def _rebase(o, d, inv12):
    """World rays into instance space by the per-lane affine rows [R, 12]
    (9 linear, row-major, then 3 translation); d is not renormalized, so
    t carries over."""
    return matvec(inv12[:, :9], o) + inv12[:, 9:12], matvec(inv12[:, :9], d)


def _walk_step(pack, o, d, inv_d, node, end, t_lim):
    """One lockstep step over the splice: (active, box_hit, is_leaf, skip,
    instance id, the clamped node index, tidx [R, LEAF_SIZE], the re-based
    ray o2, d2, its leaf's triangle rows t9 [R, LEAF_SIZE, 9])."""
    nodes = pack.inst_nodes
    active = node < end
    ni = torch.clamp(node, max=end - 1)
    nd = nodes[ni]
    lo, hi = nd[:, 0:3], nd[:, 3:6]
    first, count = nd[:, 6].long(), nd[:, 7].long()
    skip, iid = nd[:, 8].long(), nd[:, 9].to(torch.int32)
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    box_hit = (tf >= torch.clamp(tn, min=0.0)) & (tn < t_lim)
    is_leaf = count > 0
    o2, d2 = _rebase(o, d, pack.inst_inv[torch.clamp(iid, min=0).long()])
    lanes = torch.arange(LEAF_SIZE, device=o.device)[None]
    tidx = torch.where(lanes < count[:, None], first[:, None] + lanes,
                       pack.inst_tri9.shape[0] - 1)
    return (active, box_hit, is_leaf, skip, iid, ni, tidx, o2, d2, pack.inst_tri9[tidx])


def inst_closest(pack, o, d, best_t, best_prim, best_u, best_v, best_inst):
    """Closest hit over the spliced hierarchy (reference tlas.py:284-359):
    the lockstep walk of accel/intersect.py `_bvh_traverse`, with each
    leaf's triangles met by the ray re-based into its instance's frame.
    Returns (t, prim, u, v, inst), the arguments where nothing nearer."""
    from mitsuba_tpu_torch.accel.intersect import _moller_trumbore

    end = pack.inst_nodes.shape[0]
    inv_d = safe_inv(d)
    node = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    bt, bp, bu, bv, bi = (x.clone() for x in (best_t, best_prim, best_u, best_v, best_inst))
    cols = torch.arange(LEAF_SIZE, device=o.device)[None]
    while bool((node < end).any()):
        active, box_hit, is_leaf, skip, iid, ni, tidx, o2, d2, t9 = _walk_step(
            pack, o, d, inv_d, node, end, bt)
        hit, t, u, v = _moller_trumbore(o2[:, None], d2[:, None], t9[..., 0:3], t9[..., 3:6],
                                        t9[..., 6:9], bt[:, None])
        hit = hit & (box_hit & is_leaf & active)[:, None]
        t = torch.where(hit, t, torch.inf)
        tk = t.amin(dim=-1)
        # the first minimum on ties, as jnp.argmin
        k = torch.where(t == tk[:, None], cols, LEAF_SIZE).amin(dim=-1, keepdim=True)
        k = torch.clamp(k, max=LEAF_SIZE - 1)  # a NaN ray matches no column
        better = tk < bt
        row = tidx.gather(1, k)[:, 0]
        bp = torch.where(better, pack.inst_tri2prim[row], bp)
        bu = torch.where(better, u.gather(1, k)[:, 0], bu)
        bv = torch.where(better, v.gather(1, k)[:, 0], bv)
        bi = torch.where(better, iid, bi)
        bt = torch.minimum(bt, tk)
        nxt = torch.where(box_hit & ~is_leaf, ni + 1, skip)
        node = torch.where(active, nxt, node)
    return bt, bp, bu, bv, bi


def inst_any(pack, o, d, t_max):
    """Any hit below t_max over the spliced hierarchy (reference
    tlas.py:362-418); a lane stops at its first hit."""
    from mitsuba_tpu_torch.accel.intersect import _moller_trumbore, _t_max_rays

    end = pack.inst_nodes.shape[0]
    inv_d = safe_inv(d)
    tm = _t_max_rays(t_max, o)
    node = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    while bool((node < end).any()):
        active, box_hit, is_leaf, skip, _, ni, _, o2, d2, t9 = _walk_step(
            pack, o, d, inv_d, node, end, tm)
        hit, _, _, _ = _moller_trumbore(o2[:, None], d2[:, None], t9[..., 0:3], t9[..., 3:6],
                                        t9[..., 6:9], tm[:, None])
        occ = occ | (hit & (box_hit & is_leaf & active)[:, None]).any(dim=-1)
        nxt = torch.where(box_hit & ~is_leaf, ni + 1, skip)
        nxt = torch.where(occ, end, nxt)  # a lane that hit leaves the walk
        node = torch.where(active, nxt, node)
    return occ


# ---------------------------------------------------------------------------
# the pair path: instances as clusters (reference tlas.py:421-599)
# ---------------------------------------------------------------------------

def _group_view(pack, gi, g_items):
    """The pack view of group gi's cluster tables (keys ig{gi}_*) with
    its cluster meta, for accel/pairs.py.  The pair kernels' row copy of
    the group's cl_tri is made on the first view and kept in the pack."""
    from mitsuba_tpu_torch.scene.builder import ScenePack

    pre = f"ig{gi}_"
    view = ScenePack({k[len(pre):]: v for k, v in pack.arrays.items() if k.startswith(pre)},
                     dict(g_items))
    if "cl_tri_rows" not in view.arrays:
        pack.arrays[pre + "cl_tri_rows"] = pairs._tri_rows(view)
    return view


def _inst_lists_tile(o, d, tmax, boxes, k):
    """Rays [rt] x every instance box -> (ids [rt, k] by ascending slab
    entry, ties to the lower id, as lax.top_k keeps them; -1 past the
    boxes hit; overflow [rt]: more than k boxes hit)."""
    rt = o.shape[0]
    inv = safe_inv(d)
    keys = torch.full((rt, k), _BIG, dtype=torch.float32, device=o.device)
    ids = torch.full((rt, k), -1, dtype=torch.int32, device=o.device)
    cnt = torch.zeros(rt, dtype=torch.int32, device=o.device)
    for c0 in range(0, boxes.shape[0], _CULL_I):
        ch = min(_CULL_I, boxes.shape[0] - c0)
        lo, hi = boxes[c0:c0 + ch, 0:3], boxes[c0:c0 + ch, 3:6]
        t0 = (lo[None] - o[:, None]) * inv[:, None]  # [rt, ch, 3]
        t1 = (hi[None] - o[:, None]) * inv[:, None]
        tn = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=0.0)
        tf = torch.maximum(t0, t1).amin(dim=-1)
        hit = (tf >= tn) & (tn < tmax[:, None])
        cnt = cnt + hit.sum(dim=-1, dtype=torch.int32)
        allk = torch.cat([keys, torch.where(hit, tn, _BIG)], dim=1)
        alli = torch.cat([ids, torch.arange(c0, c0 + ch, dtype=torch.int32,
                                            device=o.device).expand(rt, ch)], dim=1)
        keys, idx = pairs._k_smallest(allk, k)
        ids = alli.gather(1, idx)
    return torch.where(keys < _BIG, ids, -1), cnt > k


def _inst_lists(pack, o, d, tmax, k):
    """(ids [R, k], overflow [R]) of `_inst_lists_tile` in tiles of
    _CULL_R rays."""
    out = [_inst_lists_tile(o[s:s + _CULL_R], d[s:s + _CULL_R], tmax[s:s + _CULL_R],
                            pack.inst_wbox, k)
           for s in range(0, o.shape[0], _CULL_R)]
    if len(out) == 1:
        return out[0]
    return torch.cat([x[0] for x in out]), torch.cat([x[1] for x in out])


def _rounds(pack, o, d, ids):
    """Per round of the instance lists and per group: (lanes of the group
    in that round, its instance ids, the re-based rays, the group's
    index, (lo, count, meta items))."""
    grp = pack.inst_group
    for rd in range(ids.shape[1]):
        iid = ids[:, rd]
        valid = iid >= 0
        safe = torch.clamp(iid, min=0).long()
        o2, d2 = _rebase(o, d, pack.inst_inv[safe])
        gsel = grp[safe]
        for gi, g in enumerate(pack.meta["inst_groups"]):
            yield valid & (gsel == gi), iid, o2, d2, gi, g


def inst_closest_pairs(pack, o, d, best_t, best_prim, best_u, best_v, best_inst):
    """Closest hit over the instances by the pair path (reference
    tlas.py:509-565); equal to inst_closest, whose walk finishes the rays
    that met more than K_INST instance boxes (compacted to those rays)."""
    ids, overflow = _inst_lists(pack, o, d, best_t, K_INST)
    for sel, iid, o2, d2, gi, (_, _, g_items) in _rounds(pack, o, d, ids):
        gv = _group_view(pack, gi, g_items)
        t, p, u, v = pairs.pair_closest(gv, o2, d2, torch.where(sel, best_t, 0.0))
        better = sel & (p >= 0) & (t < best_t)
        gp = pack.arrays[f"ig{gi}_t2p"][torch.clamp(p, min=0).long()]
        best_prim = torch.where(better, gp, best_prim)
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)
        best_inst = torch.where(better, iid, best_inst)
        best_t = torch.where(better, t, best_t)
    ov = torch.nonzero(overflow).squeeze(1)
    inst_closest_pairs.rays += o.shape[0]
    inst_closest_pairs.overflow_rays += ov.numel()
    if ov.numel():
        n = ov.numel()
        z = torch.zeros(n, dtype=torch.float32, device=o.device)
        none = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        ft, fp, fu, fv, fi = inst_closest(pack, o[ov], d[ov], best_t[ov], none, z, z, none)
        use = (fp >= 0) & (ft < best_t[ov])
        best_t[ov] = torch.where(use, ft, best_t[ov])
        best_prim[ov] = torch.where(use, fp, best_prim[ov])
        best_u[ov] = torch.where(use, fu, best_u[ov])
        best_v[ov] = torch.where(use, fv, best_v[ov])
        best_inst[ov] = torch.where(use, fi, best_inst[ov])
    return best_t, best_prim, best_u, best_v, best_inst


def inst_any_pairs(pack, o, d, t_max):
    """Occlusion over the instances by the pair path (reference
    tlas.py:567-599); overflowing rays that nothing occluded yet finish
    by inst_any."""
    from mitsuba_tpu_torch.accel.intersect import _t_max_rays

    tm0 = _t_max_rays(t_max, o).contiguous()
    ids, overflow = _inst_lists(pack, o, d, tm0, K_INST)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for sel, _, o2, d2, gi, (_, _, g_items) in _rounds(pack, o, d, ids):
        sel = sel & ~occ
        hit = pairs.pair_any(_group_view(pack, gi, g_items), o2, d2,
                             torch.where(sel, tm0, 0.0))
        occ = occ | (hit & sel)
    ov = torch.nonzero(overflow & ~occ).squeeze(1)
    inst_any_pairs.rays += o.shape[0]
    inst_any_pairs.overflow_rays += ov.numel()
    if ov.numel():
        occ[ov] = inst_any(pack, o[ov], d[ov], tm0[ov])
    return occ


for _fn in (inst_closest_pairs, inst_any_pairs):
    _fn.rays = 0
    _fn.overflow_rays = 0
