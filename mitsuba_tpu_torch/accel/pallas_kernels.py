"""Brute-force closest-hit / any-hit: every ray against every triangle.

The port of the four brute-force kernel pairs of
mitsuba_tpu/accel/pallas_kernels.py; the TPU layouts (rays or triangles
on lanes, ray tiles sized to VMEM) are not carried over:

* K1/K2 `_closest_kernel_v2` / `_any_kernel_v2` (`closest_hit_v2` /
  `any_hit_v2`) on the sublane pack `tri_s` (Tp a multiple of 8), the
  render path's brute force: `csrc/brute_tiled.cu` `brute_kernel`,
  persistent blocks that stage the set once, test only its live columns
  (`live_columns`) and settle without a test the rays that cannot hit.
* K11 `_closest_kernel` / `_any_kernel` (`closest_hit` / `any_hit`) on
  the transposed pack `tri_t` (Tp a multiple of 128), the same function
  on another padding of the same [9, Tp] layout: `csrc/brute_tiled.cu`
  `v1_kernel`, one thread per ray, triangle tiles streamed through shared
  memory.  Neither has a triangle cap.
* K12 `_mxu_closest_kernel` / `_mxu_any_kernel` (`closest_hit_mxu` /
  `any_hit_mxu`): Moller-Trumbore as one bilinear product of the ray
  features [d, o x d, o, 1] with `build_mt_matrix`'s [16, 4 Tp] operand;
  `csrc/brute_tiled.cu`, one thread per ray, in full float32.

Each wrapper runs the plain PyTorch version when its tensors lie on the
CPU, and the CUDA kernel when they lie on a GPU; there is no fallback
from one to the other.  Each wrapper counts its kernel launches in
`.launches`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mitsuba_tpu_torch import native

RAY_EPS = 1e-4
V2_TRI_SUB = 8  # triangle padding granularity of tri_s
TRI_TILE = 128  # triangle padding granularity of tri_t and mt_matrix
V2_CHUNK = 512  # triangles per staged chunk of K1/K2's kernel (kChunk)
MT_ROWS = 10  # rows of mt_matrix that meet a nonzero ray feature
# rays per step of the plain versions at up to PLAIN_CHUNK_COLS triangle
# columns (fewer past it): bounds their [rays, Tp] temporaries
PLAIN_RAY_CHUNK = 1 << 16
PLAIN_CHUNK_COLS = 512


def _padded(tri_v0, tri_e1, tri_e2, n_tris, multiple, v0_fill):
    """The first n_tris rows of each [T,3] array, padded with v0 = v0_fill
    and zero edges to a multiple of `multiple` rows (at least one)."""
    pad_to = max(((n_tris + multiple - 1) // multiple) * multiple, multiple)
    v0 = np.full((pad_to, 3), v0_fill, np.float32)
    e1 = np.zeros((pad_to, 3), np.float32)
    e2 = np.zeros((pad_to, 3), np.float32)
    v0[:n_tris] = np.asarray(tri_v0)[:n_tris]
    e1[:n_tris] = np.asarray(tri_e1)[:n_tris]
    e2[:n_tris] = np.asarray(tri_e2)[:n_tris]
    return v0, e1, e2


def pack_triangles_sublane(tri_v0, tri_e1, tri_e2, n_tris):
    """[T,3] x3 -> [9, Tp] numpy, Tp a multiple of 8 (at least 8);
    padding columns have v0 = 1e30 and zero edges (never hit)."""
    v0, e1, e2 = _padded(tri_v0, tri_e1, tri_e2, n_tris, V2_TRI_SUB, 1e30)
    return np.ascontiguousarray(np.concatenate([v0.T, e1.T, e2.T], axis=0))


def pack_triangles_transposed(tri_v0, tri_e1, tri_e2, n_tris):
    """[T,3] x3 -> [9, Tp] numpy (rows v0xyz, e1xyz, e2xyz), Tp a multiple
    of 128 (at least 128); padding columns have v0 = 1e30 and zero edges
    (never hit).  The K11 layout."""
    v0, e1, e2 = _padded(tri_v0, tri_e1, tri_e2, n_tris, TRI_TILE, 1e30)
    return np.concatenate([v0.T, e1.T, e2.T], axis=0)


def build_mt_matrix(tri_v0, tri_e1, tri_e2, n_tris):
    """Per-triangle constants -> [16, 4 Tp] numpy operand of the bilinear
    Moller-Trumbore (K12), Tp a multiple of 128.  Rows 0-2 meet the ray
    feature d, 3-5 w = o x d, 6-8 o, 9 the constant 1; rows 10-15 are zero.
    Column blocks [det | u_num | v_num | t_num]:

        det   = F . [-n,       0,   0, 0  ]      n  = e1 x e2
        u_num = F . [v0 x e2,  e2,  0, 0  ]
        v_num = F . [e1 x v0, -e1,  0, 0  ]
        t_num = F . [0,        0,   n, -c0]      c0 = v0 . n

    Padding triangles are all zero: det = 0, never hit."""
    v0, e1, e2 = _padded(tri_v0, tri_e1, tri_e2, n_tris, TRI_TILE, 0.0)
    n = np.cross(e1, e2)
    c0 = np.sum(v0 * n, axis=-1)
    m = np.zeros((16, 4, len(v0)), np.float32)
    m[0:3, 0] = -n.T                    # det
    m[0:3, 1] = np.cross(v0, e2).T      # u_num (d-part)
    m[3:6, 1] = e2.T                    # u_num (w-part)
    m[0:3, 2] = np.cross(e1, v0).T      # v_num (d-part)
    m[3:6, 2] = -e1.T                   # v_num (w-part)
    m[6:9, 3] = n.T                     # t_num (o-part)
    m[9, 3] = -c0                       # t_num (const)
    return m.reshape(16, 4 * len(v0))


def ray_features(o, d):
    """[R,3] x2 -> [R,16] f32 contiguous: d, w = o x d, o, 1, six zeros
    (the cross product in the reference's expression order)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    w = torch.stack([oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx], -1)
    ones = torch.ones(o.shape[:-1] + (1,), dtype=o.dtype, device=o.device)
    zeros = torch.zeros(o.shape[:-1] + (6,), dtype=o.dtype, device=o.device)
    return torch.cat([d, w, o, ones, zeros], -1).contiguous()


def mt_test(ray, tri, t_lim):
    """Moller-Trumbore in the CUDA kernels' expression order (mt_hit in
    csrc/ray_tri.cuh).  ray: (ox, oy, oz, dx, dy,
    dz); tri: the 9 rows (v0xyz, e1xyz, e2xyz); all broadcast against each
    other and t_lim.  Returns (t, u, v, hit)."""
    ox, oy, oz, dx, dy, dz = ray
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (
        ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > RAY_EPS) & (t < t_lim)
    )
    return t, u, v, hit


def _mt_hit(o, d, tri_s, t_lim):
    """[R,1] ray components against [1,Tp] triangle rows -> (t, hit)
    [R, Tp]."""
    ray = [o[:, a:a + 1] for a in range(3)] + [d[:, a:a + 1] for a in range(3)]
    t, _, _, hit = mt_test(
        ray, [tri_s[k:k + 1, :] for k in range(9)], t_lim[:, None]
    )
    return t, hit


def _ray_chunks(r, cols):
    step = max(PLAIN_RAY_CHUNK * PLAIN_CHUNK_COLS // max(cols, PLAIN_CHUNK_COLS), 1)
    return [(s, min(s + step, r)) for s in range(0, r, step)]


def _closest_of(t, hit, t_lim, cols):
    """[R, Tp] tests -> (t [R], prim [R] i32): min(t_hit, t_lim) and the
    first column with the smallest hit distance, -1 when none lies
    before t_lim."""
    t = torch.where(hit, t, torch.inf)
    tmin = t.amin(dim=1)
    # argmin with an explicit first-index tie-break
    row = torch.where(t == tmin[:, None], cols, cols.numel()).amin(dim=1)
    return torch.minimum(tmin, t_lim), torch.where(tmin < t_lim, row, -1).to(torch.int32)


def closest_hit_plain(o, d, t_max, tri_s):
    """Plain PyTorch K1 (and K11).  o, d: [R,3] f32; t_max: [R] f32 (may be
    inf); tri_s: [9, Tp].  Returns (t [R] f32, prim [R] i32): t =
    min(t_hit, t_max); prim = the first triangle with the smallest hit
    distance, or -1 when no hit lies before t_max."""
    r = o.shape[0]
    t_out = torch.empty(r, dtype=torch.float32, device=o.device)
    prim = torch.empty(r, dtype=torch.int32, device=o.device)
    cols = torch.arange(tri_s.shape[1], dtype=torch.int32, device=o.device)
    for s, e in _ray_chunks(r, tri_s.shape[1]):
        t, hit = _mt_hit(o[s:e], d[s:e], tri_s, t_max[s:e])
        t_out[s:e], prim[s:e] = _closest_of(t, hit, t_max[s:e], cols)
    return t_out, prim


def any_hit_plain(o, d, t_max, tri_s):
    """Plain PyTorch K2 (and K11): True where some triangle is hit with t
    in (RAY_EPS, t_max).  Same inputs as closest_hit_plain."""
    r = o.shape[0]
    occ = torch.empty(r, dtype=torch.bool, device=o.device)
    for s, e in _ray_chunks(r, tri_s.shape[1]):
        _, hit = _mt_hit(o[s:e], d[s:e], tri_s, t_max[s:e])
        occ[s:e] = hit.any(dim=1)
    return occ


# K11 computes K1/K2's function on tri_t: the same plain versions
closest_hit_v1_plain = closest_hit_plain
any_hit_v1_plain = any_hit_plain


def _mxu_dot(f, m, c0, c1):
    """[R,16] features x columns [c0, c1) of mt_matrix -> [R, c1 - c0]:
    each dot summed over rows 0..MT_ROWS-1 in order, one product and one
    sum at a time (the kernel's order).  Rows 10-15 meet the features'
    zero pad and add nothing."""
    acc = f[:, 0:1] * m[0:1, c0:c1]
    for k in range(1, MT_ROWS):
        acc = acc + f[:, k:k + 1] * m[k:k + 1, c0:c1]
    return acc


def _mxu_hits(f, m, t_lim):
    """The reference's `_mxu_epilogue` on the bilinear products: [R,16]
    features against mt_matrix [16, 4 Tp] -> (t, hit) [R, Tp]."""
    n = m.shape[1] // 4
    det = _mxu_dot(f, m, 0, n)
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / det, 0.0)
    u = _mxu_dot(f, m, n, 2 * n) * inv
    v = _mxu_dot(f, m, 2 * n, 3 * n) * inv
    t = _mxu_dot(f, m, 3 * n, 4 * n) * inv
    hit = (
        ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > RAY_EPS) & (t < t_lim[:, None])
    )
    return t, hit


def closest_hit_mxu_plain(o, d, t_max, mt_matrix):
    """Plain PyTorch K12.  o, d: [R,3] f32; t_max: [R] f32 (may be inf);
    mt_matrix: [16, 4 Tp] from build_mt_matrix.  Returns (t, prim) as
    closest_hit_plain."""
    r = o.shape[0]
    f = ray_features(o, d)
    n = mt_matrix.shape[1] // 4
    t_out = torch.empty(r, dtype=torch.float32, device=o.device)
    prim = torch.empty(r, dtype=torch.int32, device=o.device)
    cols = torch.arange(n, dtype=torch.int32, device=o.device)
    for s, e in _ray_chunks(r, 4 * n):
        t, hit = _mxu_hits(f[s:e], mt_matrix, t_max[s:e])
        t_out[s:e], prim[s:e] = _closest_of(t, hit, t_max[s:e], cols)
    return t_out, prim


def any_hit_mxu_plain(o, d, t_max, mt_matrix):
    """Plain PyTorch K12, occlusion: True where some triangle is hit with
    t in (RAY_EPS, t_max)."""
    r = o.shape[0]
    f = ray_features(o, d)
    occ = torch.empty(r, dtype=torch.bool, device=o.device)
    for s, e in _ray_chunks(r, mt_matrix.shape[1]):
        _, hit = _mxu_hits(f[s:e], mt_matrix, t_max[s:e])
        occ[s:e] = hit.any(dim=1)
    return occ


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mts_closest_hit_v2.argtypes = [p, p, p, p, i, i, p, p, p]
    lib.mts_any_hit_v2.argtypes = [p, p, p, p, i, i, p, p]
    lib.mts_closest_hit_tiled.argtypes = [p, p, p, p, i, i, p, p, p]
    lib.mts_any_hit_tiled.argtypes = [p, p, p, p, i, i, p, p]
    lib.mts_closest_hit_mxu.argtypes = [p, p, p, i, i, p, p, p]
    lib.mts_any_hit_mxu.argtypes = [p, p, p, i, i, p, p]
    for fn in ("mts_closest_hit_v2", "mts_any_hit_v2", "mts_closest_hit_tiled",
               "mts_any_hit_tiled", "mts_closest_hit_mxu", "mts_any_hit_mxu"):
        getattr(lib, fn).restype = i


def _lib():
    return native.load("brute_tiled", _declare)


def _prepare(o, d, t_max, tri, name="tri_s", rows=9, col_multiple=1):
    """Check what the kernels take; returns (o, d, t_max, tri) as
    contiguous tensors with t_max broadcast to [R].  A float32 [R] t_max on
    o's device (as accel/intersect.py passes it) is used as it is, and
    `.contiguous()` returns a contiguous tensor itself."""
    r = o.shape[0]
    if not (type(t_max) is torch.Tensor and t_max.dtype == torch.float32
            and t_max.shape == (r,) and t_max.device == o.device):
        t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r)
    native.check_tensors(
        o, ("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
        (name, tri, torch.float32, None),
    )
    if tri.ndim != 2 or tri.shape[0] != rows or tri.shape[1] % col_multiple:
        raise ValueError(
            f"{name} must be [{rows}, N], N a multiple of {col_multiple}, "
            f"got {tuple(tri.shape)}"
        )
    return o.contiguous(), d.contiguous(), t_max.contiguous(), tri.contiguous()


def _closest_tiled(o, d, t_max, tri):
    """v1_kernel's closest hit on a [9, Tp] pack (tri_s or tri_t)."""
    t_out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    prim = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    native.launch(_lib, "mts_closest_hit_tiled", o.device, o, d, t_max, tri,
                  o.shape[0], tri.shape[1], t_out, prim)
    return t_out, prim


def _any_tiled(o, d, t_max, tri):
    """v1_kernel's occlusion on a [9, Tp] pack (tri_s or tri_t)."""
    occ = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    native.launch(_lib, "mts_any_hit_tiled", o.device, o, d, t_max, tri,
                  o.shape[0], tri.shape[1], occ)
    return occ > 0


def live_columns(tri):
    """The columns of a [9, Tp] pack that K1/K2's kernel tests, in order
    (int64 [n]): in each chunk of V2_CHUNK columns, those up to the chunk's
    last column whose edges (rows 3-8) are not all zero.  A column with
    zero edges has det = 0 and is never hit, so the columns left out change
    no result."""
    live = (tri[3:9] != 0).any(dim=0)
    cols = [torch.zeros(0, dtype=torch.int64, device=tri.device)]
    for c0 in range(0, tri.shape[1], V2_CHUNK):
        nz = torch.nonzero(live[c0:c0 + V2_CHUNK])
        if nz.numel():
            cols.append(torch.arange(c0, c0 + int(nz[-1]) + 1, device=tri.device))
    return torch.cat(cols)


def closest_hit_v2(o, d, t_max, tri_s):
    """K1: closest hit of each ray against every triangle of tri_s [9, Tp]
    (pack_triangles_sublane).  Returns (t [R] f32, prim [R] i32); see
    closest_hit_plain."""
    o, d, t_max, tri_s = _prepare(o, d, t_max, tri_s)
    if o.is_cpu:
        return closest_hit_plain(o, d, t_max, tri_s)
    r = o.shape[0]
    t_out = torch.empty(r, dtype=torch.float32, device=o.device)
    prim = torch.empty(r, dtype=torch.int32, device=o.device)
    native.launch(_lib, "mts_closest_hit_v2", o.device, o, d, t_max, tri_s, r,
                  tri_s.shape[1], t_out, prim)
    closest_hit_v2.launches += 1
    return t_out, prim


def any_hit_v2(o, d, t_max, tri_s):
    """K2: any hit with t in (RAY_EPS, t_max): bool [R]."""
    o, d, t_max, tri_s = _prepare(o, d, t_max, tri_s)
    if o.is_cpu:
        return any_hit_plain(o, d, t_max, tri_s)
    occ = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    native.launch(_lib, "mts_any_hit_v2", o.device, o, d, t_max, tri_s, o.shape[0],
                  tri_s.shape[1], occ)
    any_hit_v2.launches += 1
    return occ


def closest_hit(o, d, t_max, tri_t):
    """K11: closest hit of each ray against every triangle of tri_t [9, Tp]
    (pack_triangles_transposed; no cap on Tp).  t_max: scalar or [R], may
    be inf.  Returns (t [R] f32, prim [R] i32); see closest_hit_plain."""
    o, d, t_max, tri_t = _prepare(o, d, t_max, tri_t, "tri_t", 9, TRI_TILE)
    if o.device.type == "cpu":
        return closest_hit_v1_plain(o, d, t_max, tri_t)
    out = _closest_tiled(o, d, t_max, tri_t)
    closest_hit.launches += 1
    return out


def any_hit(o, d, t_max, tri_t):
    """K11, occlusion: bool [R], some triangle hit with t in (RAY_EPS,
    t_max)."""
    o, d, t_max, tri_t = _prepare(o, d, t_max, tri_t, "tri_t", 9, TRI_TILE)
    if o.device.type == "cpu":
        return any_hit_v1_plain(o, d, t_max, tri_t)
    occ = _any_tiled(o, d, t_max, tri_t)
    any_hit.launches += 1
    return occ


def closest_hit_mxu(o, d, t_max, mt_matrix):
    """K12: the closest hit by the bilinear Moller-Trumbore against
    mt_matrix [16, 4 Tp] (build_mt_matrix).  t_max: scalar or [R], may be
    inf.  Returns (t [R] f32, prim [R] i32); see closest_hit_plain."""
    o, d, t_max, mt_matrix = _prepare(o, d, t_max, mt_matrix, "mt_matrix", 16, 4 * TRI_TILE)
    if o.device.type == "cpu":
        return closest_hit_mxu_plain(o, d, t_max, mt_matrix)
    t_out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    prim = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    native.launch(_lib, "mts_closest_hit_mxu", o.device, ray_features(o, d), t_max,
                  mt_matrix, o.shape[0], mt_matrix.shape[1] // 4, t_out, prim)
    closest_hit_mxu.launches += 1
    return t_out, prim


def any_hit_mxu(o, d, t_max, mt_matrix):
    """K12, occlusion: bool [R], some triangle hit with t in (RAY_EPS,
    t_max)."""
    o, d, t_max, mt_matrix = _prepare(o, d, t_max, mt_matrix, "mt_matrix", 16, 4 * TRI_TILE)
    if o.device.type == "cpu":
        return any_hit_mxu_plain(o, d, t_max, mt_matrix)
    occ = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    native.launch(_lib, "mts_any_hit_mxu", o.device, ray_features(o, d), t_max,
                  mt_matrix, o.shape[0], mt_matrix.shape[1] // 4, occ)
    any_hit_mxu.launches += 1
    return occ > 0


for _fn in (closest_hit_v2, any_hit_v2, closest_hit, any_hit, closest_hit_mxu, any_hit_mxu):
    _fn.launches = 0
