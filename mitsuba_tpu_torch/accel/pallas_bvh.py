"""Per-ray cluster traversal: the pair pipeline's overflow fallback (port
of mitsuba_tpu/accel/pallas_bvh.py `cluster_closest` / `cluster_any`,
kernels K7 `_closest_kernel` / K8 `_any_kernel` and K9
`_mxu_closest_kernel` / K10 `_mxu_any_kernel`).

The reference sorts rays into coherent 1024-ray chunks, and each chunk
visits the union of the clusters its lanes' slab tests hit, in order of
the chunk's nearest entry (`_chunk_prepass`).  What one lane computes is
its own walk: its slab-hit clusters in order of (entry, cluster id),
stopping once the next entry exceeds its best t (closest) or at its first
hit (any).  The port computes exactly that walk per ray; the coherence
sort and the cone prepass are TPU packet devices and are not ported.

As in the reference (pallas_bvh.py:583), `cluster_closest` / `cluster_any`
take K7/K8 when the pack's triangle tiles fit the reference's VMEM budget
(`cluster_vmem_ok`, at most 1,365 clusters of 128) and K9/K10 past it.
Both pairs run one walk (csrc/cluster_walk.cuh): one warp per ray, the
lanes splitting each box scan and each visited cluster's triangles, the
closest hit over exact 32-entry windows of the ray's (entry, cluster id)
order.  K7/K8 read the boxes from shared memory, staged once per resident
block (at most 1,920 clusters); K9/K10 read them from L2 and have no
cluster cap.  Both compute the same walk, so they share one plain version.

`cluster_traverse_*` (K7/K8, csrc/cluster_hit.cu) and `cluster_stream_*`
(K9/K10, csrc/cluster_stream.cu) launch their CUDA kernels for tensors on
a GPU and run their plain PyTorch versions for tensors on the CPU; there
is no fallback from one to the other.  Each counts its kernel launches in
`.launches`, and each takes an optional `stats` output (kernel only):
each ray's clusters visited and box scans.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mitsuba_tpu_torch import native
from mitsuba_tpu_torch.accel.pallas_kernels import mt_test

RAY_EPS = 1e-4
BIG = 3e38
# bytes of one [rays, Cp, 3] f32 temporary per step of the plain versions
# (they hold about six at once): the step is sized from it and Cp
PLAIN_CHUNK_BYTES = 1 << 29


# ---------------------------------------------------------------------------
# the CUDA libraries (csrc/cluster_stream.cu, csrc/cluster_hit.cu), shared
# with accel/pairs.py
# ---------------------------------------------------------------------------

def _declare_stream(lib):
    p, i, lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.mts_stream_limits.argtypes = [p, p, p, p]
    lib.mts_two_level_cull.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                       p, p, p, p, p, p, p]
    lib.mts_window_closest.argtypes = [p, p, p, p, p, lg, i, p, p, p, i, i,
                                       p, p, p, p, p]
    lib.mts_window_any.argtypes = [p, p, p, p, p, lg, i, p, p, i, i, p, p]
    lib.mts_stream_closest.argtypes = [p, p, p, p, p, i, i, i, lg, p, p, p, p, p, p]
    lib.mts_stream_any.argtypes = [p, p, p, p, p, i, i, i, lg, p, p, p]
    for fn in ("mts_stream_limits", "mts_two_level_cull", "mts_window_closest",
               "mts_window_any", "mts_stream_closest", "mts_stream_any"):
        getattr(lib, fn).restype = i


def stream_lib():
    return native.load("cluster_stream", _declare_stream)


@functools.cache
def stream_limits():
    """(max supers, max kept supers KS, max list length K, supers per
    group box) of K5 (constants of the library, read once)."""
    out = [ctypes.c_int() for _ in range(4)]
    stream_lib().mts_stream_limits(*(ctypes.byref(x) for x in out))
    return tuple(x.value for x in out)


def launch_stream(entry, device, *args):
    """Launch a cluster_stream.cu entry point (see native.launch)."""
    native.launch(stream_lib, entry, device, *args)


def check_aligned(*named, align=16):
    """Raise unless each (name, tensor) starts on an `align`-byte boundary
    (the bulk copies and vector loads of csrc/cluster_stream.cu)."""
    for name, x in named:
        if x.data_ptr() % align:
            raise ValueError(f"{name} must start on a {align}-byte boundary")


def _declare(lib):
    p, i, lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.mts_cluster_limits.argtypes = [p, p, p]
    lib.mts_cluster_limits.restype = i
    lib.mts_dense_cull.argtypes = [p, p, p, p, i, i, i, p, p, p, p, p]
    lib.mts_pair_closest.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, p, p, p, p]
    lib.mts_pair_any.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p]
    lib.mts_cluster_closest.argtypes = [p, p, p, p, p, i, i, i, lg, p, p, p, p, p, p]
    lib.mts_cluster_any.argtypes = [p, p, p, p, p, i, i, i, lg, p, p, p]
    for fn in ("mts_dense_cull", "mts_pair_closest", "mts_pair_any",
               "mts_cluster_closest", "mts_cluster_any"):
        getattr(lib, fn).restype = i


def cluster_lib():
    return native.load("cluster_hit", _declare)


@functools.cache
def kernel_limits():
    """(max clusters, max list length K, clusters per group box of K3)
    of the compiled kernels (constants of the library, read once)."""
    out = [ctypes.c_int() for _ in range(3)]
    cluster_lib().mts_cluster_limits(*(ctypes.byref(x) for x in out))
    return tuple(x.value for x in out)


def launch(entry, device, *args):
    """Launch a cluster_hit.cu entry point (see native.launch)."""
    native.launch(cluster_lib, entry, device, *args)


def safe_inv(d):
    """1 / where(|d| < 1e-20, 1e-20, d)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)


def _chunks(r, cp):
    """Ray ranges of the plain versions' steps against cp boxes."""
    step = max(PLAIN_CHUNK_BYTES // (12 * max(cp, 1)), 1)
    return [(s, min(s + step, r)) for s in range(0, r, step)]


# ---------------------------------------------------------------------------
# plain versions of K7 / K8
# ---------------------------------------------------------------------------

def _chunk_prepass(o, d, t_max, cl_box):
    """The reference's exact prepass (pallas_bvh.py:417-442), per ray:
    every ray slab-tests every cluster box (padded clusters are inverted
    and excluded); the ray's visit order is its hits sorted by entry
    distance, ties by cluster id.

    Returns (order [R, Cp] i64, entry [R, Cp] and tn [R, Cp] in that
    order (entry BIG past the hits), n_hit [R])."""
    lo, hi = cl_box[0:3].T, cl_box[3:6].T  # [Cp, 3]
    valid_c = cl_box[3] >= cl_box[0]
    inv = safe_inv(d)
    t0 = (lo[None] - o[:, None]) * inv[:, None]  # [R, Cp, 3]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    mn, mx = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]), mn[..., 2])
    tf = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
    ent = torch.clamp(tn, min=0.0)
    hit = (tf >= ent) & (tn < t_max[:, None]) & valid_c[None]
    key = torch.where(hit, ent, BIG)
    entry, order = torch.sort(key, dim=1, stable=True)
    return order, entry, torch.gather(tn, 1, order), hit.sum(dim=1)


def _cluster_rows(cl_tri, cid, tc):
    """The 9 triangle rows of each ray's cluster: [9, n, tc]."""
    col = cid[:, None] * tc + torch.arange(tc, device=cid.device)[None]
    return cl_tri[:, col]


def _traverse_plain(o, d, t_max, cl_box, cl_tri, tc, closest):
    """Shared walk of the plain K7/K8: visit each ray's prepass hits in
    order while (closest) the next entry <= best t or (any) no hit yet."""
    r = o.shape[0]
    best_t = t_max.clone()
    slot = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros(r, dtype=torch.float32, device=o.device)
    best_v = torch.zeros(r, dtype=torch.float32, device=o.device)
    occ = t_max <= 0.0
    cols = torch.arange(tc, dtype=torch.int32, device=o.device)
    for s, e in _chunks(r, cl_box.shape[1]):
        order, entry, tn_s, n_hit = _chunk_prepass(o[s:e], d[s:e], t_max[s:e], cl_box)
        running = torch.ones(e - s, dtype=torch.bool, device=o.device)
        for h in range(int(n_hit.max()) if e > s else 0):
            bt = best_t[s:e]
            if closest:
                running &= (h < n_hit) & (entry[:, h] <= bt)
                visit = running & (tn_s[:, h] < bt)
            else:
                running &= (h < n_hit) & ~occ[s:e]
                visit = running
            rows = torch.nonzero(visit).squeeze(1)
            if rows.numel() == 0:
                if not bool(running.any()):
                    break
                continue
            cid = order[rows, h]
            ray = [o[s:e][rows, a:a + 1] for a in range(3)] + [
                d[s:e][rows, a:a + 1] for a in range(3)
            ]
            t_lim = bt[rows] if closest else t_max[s:e][rows]
            t, u, v, hit = mt_test(ray, _cluster_rows(cl_tri, cid, tc), t_lim[:, None])
            g = rows + s
            if closest:
                t = torch.where(hit, t, torch.inf)
                tmin = t.amin(dim=1)
                row = torch.where(t == tmin[:, None], cols, tc).amin(dim=1)
                better = tmin < t_lim
                rsel = row.clamp(max=tc - 1).long()[:, None]
                best_t[g] = torch.where(better, tmin, t_lim)
                slot[g] = torch.where(better, (cid * tc + row).to(torch.int32), slot[g])
                best_u[g] = torch.where(better, u.gather(1, rsel)[:, 0], best_u[g])
                best_v[g] = torch.where(better, v.gather(1, rsel)[:, 0], best_v[g])
            else:
                occ[g] = occ[g] | hit.any(dim=1)
    if closest:
        return best_t, slot, best_u, best_v
    return occ


def cluster_traverse_closest_plain(o, d, t_max, cl_box, cl_tri, tc):
    """Plain K7.  o, d: [R, 3]; t_max: [R] finite.  Returns (t [R]: the
    closest hit's t, t_max on a miss; slot [R] i32: cid * tc + row, -1 on
    a miss; u, v [R])."""
    return _traverse_plain(o, d, t_max, cl_box, cl_tri, tc, closest=True)


def cluster_traverse_any_plain(o, d, t_max, cl_box, cl_tri, tc):
    """Plain K8: bool [R], some triangle hit with t in (RAY_EPS, t_max),
    or t_max <= 0 (the reference's initial occlusion)."""
    return _traverse_plain(o, d, t_max, cl_box, cl_tri, tc, closest=False)


# K9/K10 compute K7/K8's walk with the boxes read from L2: the same plain versions
cluster_stream_closest_plain = cluster_traverse_closest_plain
cluster_stream_any_plain = cluster_traverse_any_plain


# ---------------------------------------------------------------------------
# wrappers: kernel on a GPU, plain version on the CPU
# ---------------------------------------------------------------------------

def _prepare(o, d, t_max, cl_box, cl_tri, tc):
    r = o.shape[0]
    native.check_tensors(
        o, ("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
        ("t_max", t_max, torch.float32, (r,)),
        ("cl_box", cl_box, torch.float32, None),
        ("cl_tri", cl_tri, torch.float32, None),
    )
    if cl_box.ndim != 2 or cl_box.shape[0] != 8:
        raise ValueError(f"cl_box must be [8, Cp], got {tuple(cl_box.shape)}")
    if cl_tri.ndim != 2 or cl_tri.shape[0] != 9 or cl_tri.shape[1] % tc:
        raise ValueError(f"cl_tri must be [9, C*{tc}], got {tuple(cl_tri.shape)}")
    return (o.contiguous(), d.contiguous(), t_max.contiguous(),
            cl_box.contiguous(), cl_tri.contiguous())


def _walk_args(o, d, t_max, cl_box, cl_tri, tc, stats):
    """The walk kernels' leading arguments; stats: None or int32 [R, 2]."""
    if stats is not None:
        native.check_tensors(o, ("stats", stats, torch.int32, (o.shape[0], 2)))
        if not stats.is_contiguous():
            raise ValueError("stats must be contiguous")
    return (o, d, t_max, cl_box, cl_tri, o.shape[0], cl_box.shape[1], tc, cl_tri.shape[1])


def _resident_args(o, d, t_max, cl_box, cl_tri, tc, stats):
    """K7/K8's leading arguments (_walk_args), past their cluster cap checked."""
    max_c, _, _ = kernel_limits()
    if cl_box.shape[1] > max_c:
        raise ValueError(f"the traversal kernels take at most {max_c} clusters, "
                         f"got {cl_box.shape[1]}")
    return _walk_args(o, d, t_max, cl_box, cl_tri, tc, stats)


def _no_stats_on_cpu(stats):
    if stats is not None:
        raise ValueError("stats come from the kernel only")


def cluster_traverse_closest(o, d, t_max, cl_box, cl_tri, tc, stats=None):
    """K7: see cluster_traverse_closest_plain.  stats: None, or (kernel
    only) an int32 [R, 2] tensor that receives each ray's clusters visited
    (triangles tested) and box scans."""
    o, d, t_max, cl_box, cl_tri = _prepare(o, d, t_max, cl_box, cl_tri, tc)
    if o.device.type == "cpu":
        _no_stats_on_cpu(stats)
        return cluster_traverse_closest_plain(o, d, t_max, cl_box, cl_tri, tc)
    r = o.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=o.device)
    slot = torch.empty(r, dtype=torch.int32, device=o.device)
    u = torch.empty(r, dtype=torch.float32, device=o.device)
    v = torch.empty(r, dtype=torch.float32, device=o.device)
    launch("mts_cluster_closest", o.device,
           *_resident_args(o, d, t_max, cl_box, cl_tri, tc, stats), t, slot, u, v, stats)
    cluster_traverse_closest.launches += 1
    return t, slot, u, v


def cluster_traverse_any(o, d, t_max, cl_box, cl_tri, tc, stats=None):
    """K8: see cluster_traverse_any_plain; stats as for
    cluster_traverse_closest (scans are 1)."""
    o, d, t_max, cl_box, cl_tri = _prepare(o, d, t_max, cl_box, cl_tri, tc)
    if o.device.type == "cpu":
        _no_stats_on_cpu(stats)
        return cluster_traverse_any_plain(o, d, t_max, cl_box, cl_tri, tc)
    occ = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    launch("mts_cluster_any", o.device,
           *_resident_args(o, d, t_max, cl_box, cl_tri, tc, stats), occ, stats)
    cluster_traverse_any.launches += 1
    return occ > 0


def cluster_stream_closest(o, d, t_max, cl_box, cl_tri, tc, stats=None):
    """K9: K7's walk with the boxes read from L2 (no cluster cap); see
    cluster_traverse_closest_plain; stats as for cluster_traverse_closest."""
    o, d, t_max, cl_box, cl_tri = _prepare(o, d, t_max, cl_box, cl_tri, tc)
    if o.device.type == "cpu":
        _no_stats_on_cpu(stats)
        return cluster_stream_closest_plain(o, d, t_max, cl_box, cl_tri, tc)
    r = o.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=o.device)
    slot = torch.empty(r, dtype=torch.int32, device=o.device)
    u = torch.empty(r, dtype=torch.float32, device=o.device)
    v = torch.empty(r, dtype=torch.float32, device=o.device)
    launch_stream("mts_stream_closest", o.device,
                  *_walk_args(o, d, t_max, cl_box, cl_tri, tc, stats), t, slot, u, v, stats)
    cluster_stream_closest.launches += 1
    return t, slot, u, v


def cluster_stream_any(o, d, t_max, cl_box, cl_tri, tc, stats=None):
    """K10: K8's walk with the boxes read from L2; see
    cluster_traverse_any_plain; stats as for cluster_traverse_any."""
    o, d, t_max, cl_box, cl_tri = _prepare(o, d, t_max, cl_box, cl_tri, tc)
    if o.device.type == "cpu":
        _no_stats_on_cpu(stats)
        return cluster_stream_any_plain(o, d, t_max, cl_box, cl_tri, tc)
    occ = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    launch_stream("mts_stream_any", o.device,
                  *_walk_args(o, d, t_max, cl_box, cl_tri, tc, stats), occ, stats)
    cluster_stream_any.launches += 1
    return occ > 0


for _fn in (cluster_traverse_closest, cluster_traverse_any,
            cluster_stream_closest, cluster_stream_any):
    _fn.launches = 0


def finite_tmax(t_max, o):
    """(t_max broadcast to [R], and with inf mapped to BIG)."""
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    t_max = t_max.expand(o.shape[0])
    return t_max, torch.where(torch.isfinite(t_max), t_max, BIG).contiguous()


def _resident(pack):
    """K7/K8 (boxes and tiles resident) or K9/K10 (streamed), as the
    reference chooses (pallas_bvh.py:583)."""
    return pack.meta.get("cluster_vmem_ok", True)


def cluster_closest(pack, o, d, t_max):
    """Closest hit by per-ray cluster traversal.  Returns (t, prim, u, v)
    as accel/intersect._bvh_traverse does (t = t_max on a miss, prim = -1,
    u = v = 0)."""
    miss_t, tm = finite_tmax(t_max, o)
    walk = cluster_traverse_closest if _resident(pack) else cluster_stream_closest
    best_t, slot, u, v = walk(o, d, tm, pack.cl_box, pack.cl_tri, pack.meta["cluster_tc"])
    prim = torch.where(
        slot >= 0, pack.cl_pad2prim[torch.clamp(slot, min=0).long()], -1
    )
    hit = prim >= 0
    return (
        torch.where(hit, best_t, miss_t), prim,
        torch.where(hit, u, 0.0), torch.where(hit, v, 0.0),
    )


def cluster_any(pack, o, d, t_max):
    """Boolean occlusion by per-ray cluster traversal (first hit exits)."""
    _, tm = finite_tmax(t_max, o)
    walk = cluster_traverse_any if _resident(pack) else cluster_stream_any
    return walk(o, d, tm, pack.cl_box, pack.cl_tri, pack.meta["cluster_tc"])
