"""Brute-force closest-hit / any-hit for scenes of at most 512 triangles.

The port of K1 and K2 of mitsuba_tpu/accel/pallas_kernels.py
(`_closest_kernel_v2` and `_any_kernel_v2`, reached through
`closest_hit_v2` / `any_hit_v2`).  The TPU layout (rays on lanes, ray
tiles sized to VMEM) is not carried over: the Hopper kernels in
`csrc/brute_hit.cu` take rays as [R, 3] and run one thread per ray with
the triangle set in shared memory.

Each wrapper runs the plain PyTorch version when its tensors lie on the
CPU, and the CUDA kernel when they lie on a GPU; there is no fallback
from one to the other.  `closest_hit_v2.launches` and
`any_hit_v2.launches` count kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mitsuba_tpu_torch import native

RAY_EPS = 1e-4
V2_TRI_SUB = 8  # triangle padding granularity of tri_s
MAX_TRIS = 512  # shared-memory capacity of the kernels (csrc/brute_hit.cu)
# rays per step of the plain versions: bounds their [rays, Tp] temporaries
PLAIN_RAY_CHUNK = 1 << 16


def pack_triangles_sublane(tri_v0, tri_e1, tri_e2, n_tris):
    """[T,3] x3 -> [9, Tp] numpy, Tp a multiple of 8 (at least 8);
    padding columns have v0 = 1e30 and zero edges (never hit)."""
    pad_to = max(((n_tris + V2_TRI_SUB - 1) // V2_TRI_SUB) * V2_TRI_SUB, 8)
    v0 = np.full((pad_to, 3), 1e30, np.float32)
    e1 = np.zeros((pad_to, 3), np.float32)
    e2 = np.zeros((pad_to, 3), np.float32)
    v0[:n_tris] = np.asarray(tri_v0)[:n_tris]
    e1[:n_tris] = np.asarray(tri_e1)[:n_tris]
    e2[:n_tris] = np.asarray(tri_e2)[:n_tris]
    return np.ascontiguousarray(np.concatenate([v0.T, e1.T, e2.T], axis=0))


def _mt_hit(o, d, tri_s, t_lim):
    """[R,1] ray components against [1,Tp] triangle rows -> (t, hit)
    [R, Tp].  Same expression order as the CUDA kernel's mt_hit."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tri_s[k:k + 1, :] for k in range(9)
    )
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
        & (t > RAY_EPS) & (t < t_lim[:, None])
    )
    return t, hit


def _ray_chunks(r):
    return [(s, min(s + PLAIN_RAY_CHUNK, r)) for s in range(0, r, PLAIN_RAY_CHUNK)]


def closest_hit_plain(o, d, t_max, tri_s):
    """Plain PyTorch K1.  o, d: [R,3] f32; t_max: [R] f32 (finite, the
    caller maps inf to 1e30); tri_s: [9, Tp].  Returns (t [R] f32, prim
    [R] i32): t = min(t_hit, t_max); prim = the first triangle with the
    smallest hit distance, or -1 when no hit lies before t_max."""
    r = o.shape[0]
    t_out = torch.empty(r, dtype=torch.float32, device=o.device)
    prim = torch.empty(r, dtype=torch.int32, device=o.device)
    cols = torch.arange(tri_s.shape[1], dtype=torch.int32, device=o.device)
    for s, e in _ray_chunks(r):
        t_lim = t_max[s:e]
        t, hit = _mt_hit(o[s:e], d[s:e], tri_s, t_lim)
        t = torch.where(hit, t, torch.inf)
        tmin = t.amin(dim=1)
        # argmin with an explicit first-index tie-break
        row = torch.where(t == tmin[:, None], cols, tri_s.shape[1]).amin(dim=1)
        prim[s:e] = torch.where(tmin < t_lim, row, -1)
        t_out[s:e] = torch.minimum(tmin, t_lim)
    return t_out, prim


def any_hit_plain(o, d, t_max, tri_s):
    """Plain PyTorch K2: True where some triangle is hit with t in
    (RAY_EPS, t_max).  Same inputs as closest_hit_plain."""
    r = o.shape[0]
    occ = torch.empty(r, dtype=torch.bool, device=o.device)
    for s, e in _ray_chunks(r):
        _, hit = _mt_hit(o[s:e], d[s:e], tri_s, t_max[s:e])
        occ[s:e] = hit.any(dim=1)
    return occ


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mts_closest_hit_v2.argtypes = [p, p, p, p, i, i, p, p, p]
    lib.mts_closest_hit_v2.restype = i
    lib.mts_any_hit_v2.argtypes = [p, p, p, p, i, i, p, p]
    lib.mts_any_hit_v2.restype = i
    lib.mts_max_tris.argtypes = []
    lib.mts_max_tris.restype = i
    if lib.mts_max_tris() != MAX_TRIS:
        raise RuntimeError("brute_hit library disagrees on MAX_TRIS")


def _lib():
    return native.load("brute_hit", _declare)


def _prepare(o, d, t_max, tri_s):
    """Check what the kernels take; returns (o, d, t_max, tri_s) as
    contiguous tensors with t_max broadcast to [R]."""
    r = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    t_max = t_max.expand(r)
    for name, x, shape in (
        ("o", o, (r, 3)), ("d", d, (r, 3)), ("tri_s", tri_s, None),
    ):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if tri_s.ndim != 2 or tri_s.shape[0] != 9:
        raise ValueError(f"tri_s must be [9, Tp], got {tuple(tri_s.shape)}")
    return o.contiguous(), d.contiguous(), t_max.contiguous(), tri_s.contiguous()


def _launch(entry, o, d, t_max, tri_s, *outs):
    """Launch a brute_hit.cu entry point on the current stream of o's
    device; raises on a launch error."""
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    if tri_s.shape[1] > MAX_TRIS:
        raise ValueError(
            f"brute-force kernels take at most {MAX_TRIS} triangles, "
            f"got {tri_s.shape[1]}"
        )
    fn = getattr(_lib(), entry)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = fn(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), tri_s.data_ptr(),
            o.shape[0], tri_s.shape[1], *(x.data_ptr() for x in outs), stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")


def closest_hit_v2(o, d, t_max, tri_s):
    """Closest hit of each ray against the whole (<= 512-triangle) set.
    Returns (t [R] f32, prim [R] i32); see closest_hit_plain."""
    o, d, t_max, tri_s = _prepare(o, d, t_max, tri_s)
    if o.device.type == "cpu":
        return closest_hit_plain(o, d, t_max, tri_s)
    t_out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    prim = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    _launch("mts_closest_hit_v2", o, d, t_max, tri_s, t_out, prim)
    closest_hit_v2.launches += 1
    return t_out, prim


def any_hit_v2(o, d, t_max, tri_s):
    """Any hit with t in (RAY_EPS, t_max): bool [R]."""
    o, d, t_max, tri_s = _prepare(o, d, t_max, tri_s)
    if o.device.type == "cpu":
        return any_hit_plain(o, d, t_max, tri_s)
    occ = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    _launch("mts_any_hit_v2", o, d, t_max, tri_s, occ)
    any_hit_v2.launches += 1
    return occ > 0


closest_hit_v2.launches = 0
any_hit_v2.launches = 0
