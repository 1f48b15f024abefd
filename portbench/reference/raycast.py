"""Plain closest-hit ray casting for the reference: triangles in groups of
64 along a Morton curve, a slab test of every ray against every group's
box, then Moller-Trumbore on the triangles of the groups a ray's line
meets.  Plain PyTorch in the dtype it is built with; it imports nothing of
the program and derives its groups from the triangles alone.
"""

from __future__ import annotations

import numpy as np
import torch

GROUP = 64


def cross(a, b):
    """a x b over the last axis (written out: every dtype has it)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _morton_order(centroids):
    lo, hi = centroids.min(axis=0), centroids.max(axis=0)
    q = ((centroids - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
    code = np.zeros(len(q), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return np.argsort(code, kind="stable")


class Caster:
    """Closest hits of rays against fixed triangles (v0, v1, v2 [T, 3])."""

    def __init__(self, v0, v1, v2, device, dtype=torch.float32, pair_block=1 << 18):
        v0, v1, v2 = (np.asarray(v, np.float64) for v in (v0, v1, v2))
        n = len(v0)
        order = _morton_order((v0 + v1 + v2) / 3.0)
        n_groups = -(-n // GROUP)
        pad = n_groups * GROUP - n
        ids = np.concatenate([order, np.full(pad, -1)])
        far = np.where(ids[:, None] >= 0, 0.0, np.nan)  # padding: never hit

        def grouped(v):
            return np.concatenate([v[order], np.repeat(v[order[:1]], pad, axis=0)]) + far

        g0, g1, g2 = grouped(v0), grouped(v1), grouped(v2)
        corners = np.stack([g0, g1, g2], axis=1).reshape(n_groups, GROUP * 3, 3)
        self.lo = torch.tensor(np.nanmin(corners, axis=1), dtype=dtype, device=device)
        self.hi = torch.tensor(np.nanmax(corners, axis=1), dtype=dtype, device=device)
        shape = (n_groups, GROUP, 3)
        self.g0 = torch.tensor(g0.reshape(shape), dtype=dtype, device=device)
        self.e1 = torch.tensor((g1 - g0).reshape(shape), dtype=dtype, device=device)
        self.e2 = torch.tensor((g2 - g0).reshape(shape), dtype=dtype, device=device)
        self.ids = torch.tensor(ids.reshape(n_groups, GROUP), dtype=torch.int64, device=device)
        self.dtype, self.device = dtype, device
        # rays a block: the block's slab test holds rays x groups boxes
        self.ray_block = max(4096, min(1 << 21, (1 << 24) // n_groups))
        self.pair_block = pair_block

    def closest(self, o, d, t_max=None):
        """(t, prim): the nearest hit with 0 < t < t_max (inf / -1 on a
        miss) of rays o + t d, [R, 3] each."""
        r = o.shape[0]
        t_out = torch.full((r,), float("inf"), dtype=self.dtype, device=self.device)
        p_out = torch.full((r,), -1, dtype=torch.int64, device=self.device)
        if t_max is None:
            t_max = torch.full((r,), float("inf"), dtype=self.dtype, device=self.device)
        for s in range(0, r, self.ray_block):
            e = min(s + self.ray_block, r)
            t, p = self._block(o[s:e], d[s:e], t_max[s:e])
            t_out[s:e], p_out[s:e] = t, p
        return t_out, p_out

    def _block(self, o, d, t_max):
        r = o.shape[0]
        inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
        ta = (self.lo[None] - o[:, None]) * inv[:, None]
        tb = (self.hi[None] - o[:, None]) * inv[:, None]
        near = torch.minimum(ta, tb).amax(dim=-1)
        far = torch.maximum(ta, tb).amin(dim=-1)
        meets = (near <= far) & (far >= 0) & (near < t_max[:, None])
        ray_i, grp_i = meets.nonzero(as_tuple=True)
        best = torch.full((r,), float("inf"), dtype=self.dtype, device=self.device)
        cand_t, cand_p, cand_r = [], [], []
        for s in range(0, ray_i.shape[0], self.pair_block):
            ri, gi = ray_i[s:s + self.pair_block], grp_i[s:s + self.pair_block]
            t, k = self._pairs(o[ri], d[ri], t_max[ri], gi)
            cand_t.append(t)
            cand_p.append(self.ids[gi, k])
            cand_r.append(ri)
            best.scatter_reduce_(0, ri, t, reduce="amin")
        big = torch.iinfo(torch.int64).max
        prim = torch.full((r,), big, dtype=torch.int64, device=self.device)
        for t, p, ri in zip(cand_t, cand_p, cand_r):
            # the lowest triangle id among the pairs at the nearest t
            at_best = torch.isfinite(t) & (t == best[ri])
            prim.scatter_reduce_(0, ri, torch.where(at_best, p, big), reduce="amin")
        prim = torch.where(prim == big, -1, prim)
        return torch.where(prim >= 0, best, float("inf")), prim

    def _pairs(self, o, d, t_max, gi):
        """Moller-Trumbore of each pair's ray against its group's GROUP
        triangles: (nearest t, its slot), inf where none."""
        v0, e1, e2 = self.g0[gi], self.e1[gi], self.e2[gi]
        dd = d[:, None].expand_as(e2)
        pvec = cross(dd, e2)
        det = (e1 * pvec).sum(-1)
        inv = 1.0 / det
        tvec = o[:, None] - v0
        u = (tvec * pvec).sum(-1) * inv
        qvec = cross(tvec, e1)
        v = (dd * qvec).sum(-1) * inv
        t = (e2 * qvec).sum(-1) * inv
        ok = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < t_max[:, None])
        t = torch.where(ok, t, float("inf"))
        t_min, k = t.min(dim=-1)
        return t_min, k
