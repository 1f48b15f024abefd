"""Treelet clusters: the BVH cut into subtrees of at most Tc contiguous
triangles (port of mitsuba_tpu/accel/clusters.py, the tables the port's
big-mesh path reads).

Host-side output (numpy, packed into the ScenePack):
* cl_tri   [9, C*Tc] f32 - per-cluster padded triangle tiles (v0, e1, e2
  rows; padding slots hold the builder's far triangle, never hit); read
  by K4, K6 and K7-K10
* cl_box   [8, Cp] f32 - cluster AABB lo(3)/hi(3) (+2 zero rows);
  padded clusters get inverted boxes; read by K7-K10
* cl_sup   [8, Sp] f32 - supercluster boxes, the unions of SUPER_G
  consecutive clusters (same layout; padded supers are inverted boxes,
  which K5 masks by row index); read by K5
* cl_mbox  [Sp, G*6] f32 - the cluster boxes again, in supercluster
  rows of G members; padded members are point boxes at 1e30; read by
  K3 and K5
* cl_pad2prim [C*Tc] i32 - padded slot -> triangle id; read by K4, K6,
  K7-K10

The reference also packs tables that only its TPU kernels read: the
bilinear Moller-Trumbore operand `cl_mt` and its f32 prim-id rows
`cl_primf` (the MXU form of K4/K6/K9/K10; the port's kernels run
Moller-Trumbore on cl_tri and read cl_pad2prim) and the cluster spheres
`cl_sph` (the cone prepass).
"""

from __future__ import annotations

import numpy as np

CLUSTER_TC = 128  # triangles per cluster tile (the reference's default)
SUPER_G = 16  # clusters per supercluster row of cl_mbox
# the reference keeps cl_tri resident in a 6 MiB VMEM budget; beyond it
# (cluster_vmem_ok false) its fallback is K9/K10, not K7/K8
CLUSTER_VMEM_MAX = 6 * 1024 * 1024
# the reference's HBM budget for its streamed per-cluster MT operands
# (C * Tc * 256 bytes); past it the reference packs no clusters and walks
# the BVH with XLA, which the port does not render
CLUSTER_HBM_MAX = 768 * 1024 * 1024


def cut_clusters(bvh, tc: int = CLUSTER_TC):
    """Cut the threaded-DFS BVH into subtrees of <= tc prims.

    A subtree's prims form one [first, count) run of the BVH order (both
    builders allocate `order` at leaf creation during a DFS).  Returns
    (first [C], count [C], lo [C,3], hi [C,3])."""
    n = len(bvh.skip)
    skip = np.asarray(bvh.skip, np.int64)
    count = np.asarray(bvh.count, np.int64)
    # pre[i] = prims allocated before node i in DFS order
    pre = np.zeros(n + 1, np.int64)
    np.cumsum(count, out=pre[1:])

    firsts, counts, los, his = [], [], [], []
    i = 0
    while i < n:
        sub = pre[skip[i]] - pre[i]
        if sub <= tc or count[i] > 0:
            if sub > 0:
                firsts.append(pre[i])
                counts.append(sub)
                los.append(bvh.lo[i])
                his.append(bvh.hi[i])
            i = int(skip[i])
        else:
            i += 1
    return (
        np.asarray(firsts, np.int64),
        np.asarray(counts, np.int64),
        np.asarray(los, np.float32).reshape(-1, 3),
        np.asarray(his, np.float32).reshape(-1, 3),
    )


def pack_clusters(bvh, tri_v0, tri_e1, tri_e2, n_tris, tc: int = CLUSTER_TC):
    """Cluster arrays and meta for the big-mesh kernels, or None for an
    empty BVH or one past CLUSTER_HBM_MAX (where the reference's
    pack_clusters returns None).  tri_* are the BVH-ordered triangle
    tables, padded with the far triangle at index n_tris."""
    first, cnt, lo, hi = cut_clusters(bvh, tc)
    c = len(first)
    if c == 0 or c * tc * 256 > CLUSTER_HBM_MAX:
        return None
    cp = max(((c + 7) // 8) * 8, 8)

    slot = np.arange(tc, dtype=np.int64)
    tri_idx = first[:, None] + slot[None, :]  # [C, Tc]
    valid = slot[None, :] < cnt[:, None]
    tri_idx = np.where(valid, tri_idx, n_tris).reshape(-1)  # dummies -> far tri
    v0 = np.asarray(tri_v0, np.float32)[tri_idx]
    e1 = np.asarray(tri_e1, np.float32)[tri_idx]
    e2 = np.asarray(tri_e2, np.float32)[tri_idx]
    cl_tri = np.concatenate([v0.T, e1.T, e2.T], axis=0).astype(np.float32)

    cl_box = np.zeros((8, cp), np.float32)
    cl_box[0:3, :] = 1e30  # inverted default box: never hit
    cl_box[3:6, :] = -1e30
    cl_box[0:3, :c] = lo.T
    cl_box[3:6, :c] = hi.T

    # super si covers cluster ids [si*G, (si+1)*G)
    s = (c + SUPER_G - 1) // SUPER_G
    sp = max(((s + 7) // 8) * 8, 8)
    cl_sup = np.zeros((8, sp), np.float32)
    cl_sup[0:3, :] = 1e30
    cl_sup[3:6, :] = -1e30
    for si in range(s):
        seg = slice(si * SUPER_G, min((si + 1) * SUPER_G, c))
        cl_sup[0:3, si] = lo[seg].min(axis=0)
        cl_sup[3:6, si] = hi[seg].max(axis=0)
    cl_mbox = np.full((sp * SUPER_G, 6), 1e30, np.float32)
    cl_mbox[:c, 0:3] = lo
    cl_mbox[:c, 3:6] = hi

    return {
        "cl_tri": cl_tri,
        "cl_box": cl_box,
        "cl_sup": cl_sup,
        "cl_mbox": cl_mbox.reshape(sp, SUPER_G * 6),
        "cl_pad2prim": tri_idx.astype(np.int32),
    }, {
        "n_clusters": c,
        "cluster_tc": tc,
        "n_supers": s,
        "cluster_super_g": SUPER_G,
        "cluster_vmem_ok": 9 * c * tc * 4 <= CLUSTER_VMEM_MAX,
    }
