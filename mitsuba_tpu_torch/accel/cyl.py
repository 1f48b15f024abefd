"""Analytic miter-clipped cylinder segments: hair fibers and `cylinder`
shapes (port of mitsuba_tpu/accel/cyl.py; reference src/shapes/hair.cpp
HairKDTree::intersect:485-542, src/shapes/cylinder.cpp rayIntersect).

Each ray is projected into the plane normal to a segment's axis, the
circle's quadratic is solved, and the nearer root is kept where its hit
point lies between the two miter planes ((q - p0) . n0 >= 0 and
(q - p1) . n1 <= 0), else the farther root.  The reference computes this
with XLA operations, outside any Pallas kernel, in a scan over 128-segment
tiles of every ray against every segment; here it is plain tensor
operations in two steps over blocks of rays x segments:

1. a cull: the pairs whose ray line passes within a bound of the
   segment's kept wall (a sphere about the segment's midpoint holding the
   wall between its miter planes, widened by a margin);
2. the reference's test, operation for operation, on the pairs that pass.

A pair the cull drops is a miss in the reference too: its wall lies out
of the ray's reach by more than the margin, and the padding rows (radius
0) never pass.  A closest hit is the smallest t below the caller's best t,
ties to the lowest segment id, as the reference's strict per-tile
improvement with jnp.argmin's first index gives: a root at or past the
best t of an earlier tile is rejected there, and its far root lies
further still.
"""

from __future__ import annotations

import torch

RAY_EPS = 1e-4
BIG = 1e30
# the cull's margin: relative, and absolute in scene units
MARGIN_REL, MARGIN_ABS = 1e-3, 1e-5
# a miter plane within acos(0.05) of the wall keeps it no further than
# this bound allows; past that, the segment is never culled
MIN_MITER_COS = 0.05


def _block_elems(device):
    """Pairs of rays x segments in one cull block: its temporaries are
    [rays, segments] float32 tensors."""
    return 1 << 26 if device.type == "cuda" else 1 << 22


def _table(pack):
    """(p0, unit axis, p1, n0, n1, radius, cull centre, cull radius)."""
    p0, p1, n0, n1, rad = pack.cyl_p0, pack.cyl_p1, pack.cyl_n0, pack.cyl_n1, pack.cyl_rad
    seg = p1 - p0
    ln = torch.linalg.vector_norm(seg, dim=-1)
    ax = seg / torch.clamp(ln, min=1e-20)[:, None]

    def past_end(n):
        """How far the kept wall reaches past an end along the axis, per
        unit of radius: tan of the miter plane's tilt."""
        c = _dot(n, ax)
        return torch.where(c > MIN_MITER_COS, torch.sqrt(torch.clamp(1.0 - c * c, min=0.0)) / c,
                           torch.inf)

    reach = 0.5 * ln + rad * (1.0 + past_end(n0) + past_end(n1))
    reach = torch.where(rad > 0.0, reach * (1.0 + MARGIN_REL) + MARGIN_ABS, -1.0)
    return p0, ax, p1, n0, n1, rad, 0.5 * (p0 + p1), reach


def _candidates(o, d, centre, reach):
    """(ray, segment) index pairs whose ray line passes within reach of the
    cull centre."""
    oc = [centre[None, :, k] - o[:, k, None] for k in range(3)]
    tca = oc[0] * d[:, 0, None] + oc[1] * d[:, 1, None] + oc[2] * d[:, 2, None]
    dd = (d * d).sum(dim=-1)[:, None]
    dist2 = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - tca * tca / dd
    r2 = torch.where(reach >= 0.0, reach * reach, -1.0)  # inf stays inf
    return torch.nonzero(dist2 <= r2[None, :], as_tuple=True)


def _dot(a, b):
    """[..., 3] . [..., 3], summed in the components' order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _seg_test(o, d, p0, ax, p1, n0, n1, rad, t_lim):
    """t [P] of P (ray, segment) pairs, each argument gathered per pair
    (BIG on a miss), as the reference's _seg_test computes each pair."""
    rel = o - p0
    rel_ax = _dot(rel, ax)[:, None]
    d_ax = _dot(d, ax)[:, None]
    # the components perpendicular to the axis
    po = rel - rel_ax * ax
    pd = d - d_ax * ax
    a = _dot(pd, pd)
    b = 2.0 * _dot(po, pd)
    c = _dot(po, po) - rad * rad
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0.0) & (a > 1e-20) & (rad > 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 0.5 / torch.where(ok, a, 1.0)
    t_near = (-b - sq) * inv2a
    t_far = (-b + sq) * inv2a

    def kept(t):
        q = o + t[:, None] * d
        c0 = _dot(q - p0, n0)
        c1 = _dot(q - p1, n1)
        return ok & (t > RAY_EPS) & (t < t_lim) & (c0 >= 0.0) & (c1 <= 0.0)

    return torch.where(kept(t_near), t_near, torch.where(kept(t_far), t_far, BIG))


def _pairs(pack, o, d, t_lim):
    """For each block of rays: (first ray, rays in the block, ray ids in
    the block, segment ids, t) of its candidate pairs."""
    tab = _table(pack)
    r, s = o.shape[0], tab[0].shape[0]
    rc = max(1, _block_elems(o.device) // max(s, 1))
    for i in range(0, r, rc):
        oc, dc = o[i:i + rc], d[i:i + rc]
        ri, si = _candidates(oc, dc, tab[6], tab[7])
        t = _seg_test(oc[ri], dc[ri], *(a[si] for a in tab[:6]), t_lim[i:i + rc][ri])
        yield i, oc.shape[0], ri, si, t


def cyl_closest(pack, o, d, best_t):
    """The closest segment hit below best_t: (hit [R] bool, t [R], segment
    id [R] int32, -1 without a hit)."""
    r = o.shape[0]
    bt = torch.as_tensor(best_t, dtype=torch.float32, device=o.device).expand(r).clone()
    bi = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    for i, n, ri, si, t in _pairs(pack, o, d, bt.clone()):
        tmin = torch.full((n,), BIG, device=o.device).scatter_reduce(0, ri, t, "amin")
        first = (t == tmin[ri]) & (t < BIG)
        sid = torch.full((n,), 1 << 30, dtype=torch.int64, device=o.device).scatter_reduce(
            0, ri[first], si[first], "amin")
        bt_c, bi_c = bt[i:i + n], bi[i:i + n]
        take = (tmin < bt_c) & (tmin < BIG)
        bi_c.copy_(torch.where(take, sid.to(torch.int32), bi_c))
        bt_c.copy_(torch.where(take, tmin, bt_c))
    return bi >= 0, bt, bi


def cyl_any(pack, o, d, t_max):
    """Occlusion by any segment below t_max."""
    r = o.shape[0]
    t_lim = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r)
    occ = torch.zeros(r, dtype=torch.bool, device=o.device)
    for i, _, ri, _, t in _pairs(pack, o, d, t_lim):
        occ[i:].index_fill_(0, ri[t < BIG], True)
    return occ
