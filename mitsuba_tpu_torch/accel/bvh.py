"""Host-side binned-SAH BVH with a threaded (skip-link) layout (port of
mitsuba_tpu/accel/bvh.py).

Layout: nodes in depth-first order.  For node i:
* hit  -> continue at i+1 (its first child / its leaf payload)
* miss -> continue at skip[i]
* leaf -> test prims [first, first+count), then continue at skip[i]

`build_bvh` runs the port's copy of the reference's C++ builder
(csrc/host/bvh_builder.cpp, compiled by `native.load_host`), so the port
and the reference pack the same tree; without a C++ compiler it falls
back to the numpy builder, as the reference does.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from mitsuba_tpu_torch import native

LEAF_SIZE = 8  # max prims per leaf (the reference's MTS_BVH_LEAF default)
_NUM_BINS = 16
# above this many nodes only one layout is emitted (8 copies of the nodes)
OCTANT_MAX_NODES = 1 << 19


@dataclass
class BVH:
    lo: np.ndarray  # [N, 3] node bbox min
    hi: np.ndarray  # [N, 3]
    skip: np.ndarray  # [N] int32 next-node-on-miss (N = end)
    first: np.ndarray  # [N] int32 first prim index into `order` (-1 inner)
    count: np.ndarray  # [N] int32 prim count (0 inner)
    order: np.ndarray  # [P] int32 permutation of input prims
    depth: int = 0


def build_bvh(centroids, prim_lo, prim_hi, use_native: bool = True) -> BVH:
    """Native C++ builder when it can be built, numpy otherwise."""
    if use_native and len(centroids) > 0:
        out = _build_bvh_native(centroids, prim_lo, prim_hi)
        if out is not None:
            return out
    return _build_bvh_numpy(centroids, prim_lo, prim_hi)


def octant_node_rows(bvh: BVH) -> tuple[np.ndarray, int]:
    """Row-packed nodes [(K*N), 9] = (lo, hi, first, count, skip) in K=8
    direction-ordered DFS layouts (K=1 above OCTANT_MAX_NODES or for a
    single node).  Octant o has bit a set iff d[a] < 0; in its layout the
    near child along the children's dominant separation axis comes first,
    so a closest-hit walk tightens best_t early."""
    n = len(bvh.skip)

    def rows(lo, hi, first, count, skip):
        return np.concatenate(
            [lo, hi,
             first[:, None].astype(np.float32),
             count[:, None].astype(np.float32),
             skip[:, None].astype(np.float32)],
            axis=1,
        ).astype(np.float32)

    base = rows(bvh.lo, bvh.hi, bvh.first, bvh.count, bvh.skip)
    if n > OCTANT_MAX_NODES or n <= 1:
        return base, 1

    # children from the threaded DFS layout: inner i -> left = i+1,
    # right = skip[left]
    is_leaf = bvh.count > 0
    center = (bvh.lo + bvh.hi) * 0.5
    # subtree size in the threaded DFS layout is skip[i] - i, in any order
    old_size = bvh.skip - np.arange(n)
    layouts = []
    for oct_ in range(8):
        neg = np.array([oct_ & 1, (oct_ >> 1) & 1, (oct_ >> 2) & 1], bool)
        order = np.empty(n, np.int32)  # new position -> old node id
        stack = [0]
        w = 0
        while stack:
            i = stack.pop()
            order[w] = i
            w += 1
            if not is_leaf[i]:
                left = i + 1
                right = bvh.skip[left]
                axis = int(np.argmax(np.abs(center[right] - center[left])))
                near_is_left = center[left][axis] <= center[right][axis]
                if neg[axis]:
                    near_is_left = not near_is_left
                near, far = (left, right) if near_is_left else (right, left)
                stack.append(far)  # visited second
                stack.append(near)  # visited first
        new_skip = np.arange(n) + old_size[order]
        layouts.append(
            rows(
                bvh.lo[order], bvh.hi[order],
                bvh.first[order], bvh.count[order],
                new_skip.astype(np.int32),
            )
        )
    return np.concatenate(layouts, axis=0), 8


def _declare_bvh(lib):
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    fn = lib.mts_build_bvh
    fn.restype = ctypes.c_int
    fn.argtypes = [
        f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, i32p, i32p, i32p, i32p,
    ]


def _build_bvh_native(centroids, prim_lo, prim_hi) -> BVH | None:
    """The C++ binned-SAH builder; None if it cannot be built."""
    lib = native.load_host("bvh", "bvh_builder.cpp", _declare_bvh)
    if lib is None:
        return None
    n = len(centroids)
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    cen = np.ascontiguousarray(centroids, np.float32)
    cap = 2 * n + 2
    out_lo = np.empty((cap, 3), np.float32)
    out_hi = np.empty((cap, 3), np.float32)
    out_skip = np.empty(cap, np.int32)
    out_first = np.empty(cap, np.int32)
    out_count = np.empty(cap, np.int32)
    out_order = np.empty(n, np.int32)
    out_depth = np.zeros(1, np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    f32, i32 = ctypes.c_float, ctypes.c_int32
    n_nodes = lib.mts_build_bvh(
        p(lo, f32), p(hi, f32), p(cen, f32), n, LEAF_SIZE,
        p(out_lo, f32), p(out_hi, f32), p(out_skip, i32),
        p(out_first, i32), p(out_count, i32), p(out_order, i32),
        p(out_depth, i32),
    )
    if n_nodes <= 0:
        return None
    return BVH(
        lo=out_lo[:n_nodes].copy(),
        hi=out_hi[:n_nodes].copy(),
        skip=out_skip[:n_nodes].copy(),
        first=out_first[:n_nodes].copy(),
        count=out_count[:n_nodes].copy(),
        order=out_order.copy(),
        depth=int(out_depth[0]),
    )


def _sah_split(prims, centroids, prim_lo, prim_hi):
    """Binned-SAH split of `prims` -> (left, right) prim index arrays."""
    c = centroids[prims]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    extent = cmax - cmin
    axis = int(np.argmax(extent))
    mid = len(prims) // 2
    if extent[axis] <= 1e-12:
        return prims[:mid], prims[mid:]  # degenerate: split by index
    scale = _NUM_BINS * (1.0 - 1e-6) / extent[axis]
    bins = ((c[:, axis] - cmin[axis]) * scale).astype(np.int64)
    bin_cnt = np.zeros(_NUM_BINS, np.int64)
    bin_lo = np.full((_NUM_BINS, 3), np.inf)
    bin_hi = np.full((_NUM_BINS, 3), -np.inf)
    np.add.at(bin_cnt, bins, 1)
    for a in range(3):
        np.minimum.at(bin_lo[:, a], bins, prim_lo[prims][:, a])
        np.maximum.at(bin_hi[:, a], bins, prim_hi[prims][:, a])

    def area(lo_, hi_):
        d = np.maximum(hi_ - lo_, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    l_lo = np.minimum.accumulate(bin_lo, axis=0)
    l_hi = np.maximum.accumulate(bin_hi, axis=0)
    r_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
    r_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
    l_cnt = np.cumsum(bin_cnt)
    r_cnt = np.cumsum(bin_cnt[::-1])[::-1]
    cost = area(l_lo, l_hi)[:-1] * l_cnt[:-1] + area(r_lo[1:], r_hi[1:]) * r_cnt[1:]
    cost = np.where((l_cnt[:-1] == 0) | (r_cnt[1:] == 0), np.inf, cost)
    best = int(np.argmin(cost))
    if not np.isfinite(cost[best]):
        return prims[:mid], prims[mid:]
    mask = bins <= best
    return prims[mask], prims[~mask]


def _build_bvh_numpy(centroids, prim_lo, prim_hi) -> BVH:
    """The reference's numpy fallback builder (same splits, same layout)."""
    n = len(centroids)
    if n == 0:
        return BVH(
            lo=np.zeros((1, 3), np.float32),
            hi=np.full((1, 3), -1.0, np.float32),
            skip=np.array([1], np.int32),
            first=np.array([0], np.int32),
            count=np.array([0], np.int32),
            order=np.zeros(0, np.int32),
        )

    order = np.empty(n, np.int64)
    order_pos = 0
    tree_lo, tree_hi, tree_first, tree_count, tree_right = [], [], [], [], []
    # DFS with the left child first, so nodes land in DFS order; each
    # entry is (prims, parent, is_right_child)
    stack = [(np.arange(n, dtype=np.int64), -1, False)]
    while stack:
        prims, parent, is_right = stack.pop()
        tree_lo.append(prim_lo[prims].min(axis=0))
        tree_hi.append(prim_hi[prims].max(axis=0))
        tree_first.append(-1)
        tree_count.append(0)
        tree_right.append(-1)
        me = len(tree_lo) - 1
        if parent >= 0 and is_right:
            tree_right[parent] = me
        if len(prims) <= LEAF_SIZE:
            tree_first[me] = order_pos
            tree_count[me] = len(prims)
            order[order_pos:order_pos + len(prims)] = prims
            order_pos += len(prims)
            continue
        left, right = _sah_split(prims, centroids, prim_lo, prim_hi)
        stack.append((right, me, True))
        stack.append((left, me, False))

    n_nodes = len(tree_lo)
    count_arr = np.asarray(tree_count, np.int32)
    right_arr = np.asarray(tree_right, np.int64)
    # skip links: skip[root] = end; inner i with right child r:
    # skip[i+1] = r, skip[r] = skip[i]
    skip = np.full(n_nodes, n_nodes, np.int64)
    depth = 0
    stack2 = [(0, 1)]
    while stack2:
        i, dpt = stack2.pop()
        depth = max(depth, dpt)
        r = right_arr[i]
        if count_arr[i] == 0 and r >= 0:
            skip[i + 1] = r
            skip[r] = skip[i]
            stack2.append((i + 1, dpt + 1))
            stack2.append((r, dpt + 1))
    return BVH(
        lo=np.asarray(tree_lo, np.float32),
        hi=np.asarray(tree_hi, np.float32),
        skip=skip.astype(np.int32),
        first=np.asarray(tree_first, np.int32),
        count=count_arr,
        order=order[:order_pos].astype(np.int32),
        depth=depth,
    )
