"""The plain reference path tracer: an unbiased estimate of a pixel's
value under a configuration's scene, written from Mitsuba 0.5's `path`
integrator (src/integrators/path/path.cpp) and nothing of the program.

Per sample: a film position jittered by the gaussian filter (its normal
draw clamped to the filter radius, each sample of weight 1), a pinhole
camera ray, then a loop over path vertices.  A path has at most maxDepth
edges, the camera edge included: emission seen along edge k counts for
k <= maxDepth, and next-event estimation at a vertex reached by k edges
counts while k + 1 <= maxDepth.  Diffuse BSDFs are one-sided, area lights
emit from their front side, the constant environment is sampled
uniformly over the sphere, and the light and BSDF samples are combined by
the power heuristic.  Russian roulette starts once a path has rrDepth
edges, with survival min(max throughput, 0.95).  Every float is of the
dtype asked for (float32 for the reference, bfloat16 for the control);
per-pixel statistics are summed in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.raycast import Caster, cross

INV_PI = 1.0 / math.pi
DEPTH_CAP = 64  # maxDepth -1 (unbounded) is cut here


def _normalize(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def _dot(a, b):
    return (a * b).sum(-1)


class Tracer:
    """The scene on `device` in `dtype`, ready to trace samples."""

    def __init__(self, scene, device, dtype=torch.float32):
        self.s, self.device, self.dtype = scene, device, dtype
        self.caster = Caster(scene.v0, scene.v1, scene.v2, device, dtype)

        def t(a):
            return torch.tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

        e1, e2 = scene.v1 - scene.v0, scene.v2 - scene.v0
        n = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(n, axis=-1)
        self.normal = t(n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-300))
        self.albedo, self.radiance = t(scene.albedo), t(scene.radiance)
        emitters = np.nonzero(scene.radiance.max(axis=-1) > 0)[0]
        if len(emitters) and scene.env is not None:
            raise ValueError("the reference samples either area lights or the environment")
        self.env = None if scene.env is None else t(scene.env)
        self.light_area = float(area[emitters].sum()) if len(emitters) else 0.0
        self.light_ids = torch.tensor(emitters, dtype=torch.int64, device=device)
        self.light_cdf = torch.tensor(np.cumsum(area[emitters]) / max(self.light_area, 1e-300),
                                      dtype=torch.float64, device=device)
        self.v0, self.e1, self.e2 = t(scene.v0), t(e1), t(e2)
        scale = max(np.abs(np.concatenate([scene.v0, scene.v1, scene.v2])).max(), 1.0)
        self.eps = 1e-4 * scale  # ray offset off a surface
        self.cam_o = t(scene.origin)
        self.cam_m = t(scene.to_world)
        self.max_depth = scene.max_depth if scene.max_depth > 0 else DEPTH_CAP

    def uniform(self, gen, *shape):
        return torch.rand(*shape, generator=gen, device=self.device).to(self.dtype)

    def camera_rays(self, pix, gen):
        """Rays through film positions jittered by the gaussian filter
        around pixels `pix` (flat ids y W + x)."""
        s = self.s
        jit = torch.randn(pix.shape[0], 2, generator=gen, device=self.device) * s.filter_stddev
        jit = torch.clamp(jit, -s.filter_radius, s.filter_radius).to(self.dtype)
        x = (pix % s.width).to(self.dtype) + 0.5 + jit[:, 0]
        y = (pix // s.width).to(self.dtype) + 0.5 + jit[:, 1]
        th = s.tan_half_x
        dc = torch.stack([(1.0 - 2.0 * x / s.width) * th,
                          (1.0 - 2.0 * y / s.height) * th * s.height / s.width,
                          torch.ones_like(x)], dim=-1)
        d = _normalize(dc @ self.cam_m.T)
        return self.cam_o.expand_as(d).clone(), d

    def trace(self, pix, gen):
        """One radiance sample [R, 3] (dtype) for each entry of `pix`."""
        r = pix.shape[0]
        dt, dev = self.dtype, self.device
        L = torch.zeros(r, 3, dtype=dt, device=dev)
        lane = torch.arange(r, device=dev)
        o, d = self.camera_rays(pix, gen)
        thr = torch.ones(r, 3, dtype=dt, device=dev)
        pdf_b = torch.zeros(r, dtype=dt, device=dev)  # BSDF pdf of the last edge
        for depth in range(self.max_depth):  # the ray in flight is edge depth + 1
            t, prim = self.caster.closest(o, d)
            hit = prim >= 0
            first = depth == 0
            if self.env is not None:
                esc = ~hit
                w = 1.0 if first else self._mis(pdf_b[esc], 0.25 * INV_PI)
                L.index_add_(0, lane[esc], thr[esc] * self.env * _col(w, dt, dev))
            pc = prim.clamp(min=0)
            n = self.normal[pc]
            cos_o = -_dot(d, n)
            front = hit & (cos_o > 0)
            if self.light_area > 0:
                le = self.radiance[pc]
                lit = front & (le.amax(-1) > 0)
                if first:
                    w = torch.ones_like(t[lit])
                else:
                    pdf_l = t[lit] * t[lit] / (cos_o[lit] * self.light_area)
                    w = self._mis(pdf_b[lit], pdf_l)
                L.index_add_(0, lane[lit], thr[lit] * le[lit] * w[:, None])
            # a path ends on a miss or on a surface's back side (one-sided BSDFs)
            keep = front & (self.albedo[pc].amax(-1) > 0)
            if depth + 1 >= self.max_depth or not bool(keep.any()):
                break
            idx = keep.nonzero(as_tuple=True)[0]
            lane, thr, o, d, t, n = lane[idx], thr[idx], o[idx], d[idx], t[idx], n[idx]
            albedo = self.albedo[pc[idx]]
            p = o + t[:, None] * d + self.eps * n
            L.index_add_(0, lane, self._nee(p, n, thr, albedo, gen))
            # cosine-weighted BSDF sample: weight albedo, pdf cos / pi
            d, cos_b = self._cosine(n, gen)
            pdf_b, o = cos_b * INV_PI, p
            thr = thr * albedo
            if depth + 1 >= self.s.rr_depth:
                q = torch.clamp(thr.amax(-1), max=0.95)
                live = self.uniform(gen, q.shape[0]) < q
                thr = thr / torch.where(live, q, 1.0)[:, None]
                idx = (live & (thr.amax(-1) > 0)).nonzero(as_tuple=True)[0]
                lane, thr, o, d, pdf_b = lane[idx], thr[idx], o[idx], d[idx], pdf_b[idx]
            if lane.shape[0] == 0:
                break
        return L

    def _mis(self, pdf_a, pdf_b):
        a2, b2 = pdf_a * pdf_a, pdf_b * pdf_b
        return a2 / (a2 + b2)

    def _cosine(self, n, gen):
        """Cosine-distributed directions about normals n: (d, cos)."""
        u = self.uniform(gen, n.shape[0], 2)
        r, phi = torch.sqrt(u[:, 0]), 2.0 * math.pi * u[:, 1]
        x, y = r * torch.cos(phi), r * torch.sin(phi)
        z = torch.sqrt(torch.clamp(1.0 - u[:, 0], min=0.0))
        a = torch.where((n[:, 0].abs() > 0.9)[:, None], _unit(1, n), _unit(0, n))
        t = _normalize(cross(a, n))
        b = cross(n, t)
        d = x[:, None] * t + y[:, None] * b + z[:, None] * n
        return _normalize(d), z

    def _nee(self, p, n, thr, albedo, gen):
        """Next-event estimate at points p (normals n), MIS-weighted."""
        k = p.shape[0]
        if self.env is not None:
            u = self.uniform(gen, k, 2)
            z = 1.0 - 2.0 * u[:, 0]
            rr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
            phi = 2.0 * math.pi * u[:, 1]
            wl = torch.stack([rr * torch.cos(phi), rr * torch.sin(phi), z], dim=-1)
            cos_s = _dot(wl, n)
            pdf_l = torch.full_like(cos_s, 0.25 * INV_PI)
            le = self.env.expand(k, 3)
            t_max = None
            ok = cos_s > 0
        else:
            u = self.uniform(gen, k, 3)
            which = torch.searchsorted(self.light_cdf, u[:, 0].double().clamp(max=1 - 1e-12))
            tri = self.light_ids[which.clamp(max=self.light_ids.shape[0] - 1)]
            su = torch.sqrt(u[:, 1])
            b1, b2 = su * (1.0 - u[:, 2]), su * u[:, 2]
            y = self.v0[tri] + b1[:, None] * self.e1[tri] + b2[:, None] * self.e2[tri]
            wl = y - p
            dist = torch.sqrt((wl * wl).sum(-1))
            wl = wl / dist[:, None]
            cos_s = _dot(wl, n)
            cos_l = -_dot(wl, self.normal[tri])
            pdf_l = dist * dist / (cos_l * self.light_area)
            le = self.radiance[tri]
            t_max = dist * (1.0 - 1e-3)
            ok = (cos_s > 0) & (cos_l > 0)
        idx = ok.nonzero(as_tuple=True)[0]
        out = torch.zeros(k, 3, dtype=self.dtype, device=self.device)
        if idx.shape[0] == 0:
            return out
        tm = None if t_max is None else t_max[idx]
        _, blocker = self.caster.closest(p[idx], wl[idx], tm)
        vis = blocker < 0
        pl, cs = pdf_l[idx], cos_s[idx]
        w = self._mis(pl, cs * INV_PI)
        f = albedo[idx] * (cs * INV_PI)[:, None]
        c = thr[idx] * f * le[idx] * (w / pl)[:, None]
        out[idx] = torch.where(vis[:, None], c, 0.0)
        return out


def _col(w, dtype, device):
    if isinstance(w, float):
        return torch.tensor(w, dtype=dtype, device=device)
    return w[:, None]


def _unit(axis, like):
    e = torch.zeros_like(like)
    e[:, axis] = 1.0
    return e


def render_pixels(tracer, pix, n, gen, lanes=1 << 21):
    """n samples of each pixel of `pix` ([K] flat ids): (sum [K, 3] in the
    tracer's dtype, float64 mean [K, 3], float64 sample variance [K, 3])."""
    k = pix.shape[0]
    per = max(lanes // n, 1)
    dt, dev = tracer.dtype, tracer.device
    s = torch.zeros(k, 3, dtype=dt, device=dev)
    m = torch.zeros(k, 3, dtype=torch.float64, device=dev)
    v = torch.zeros(k, 3, dtype=torch.float64, device=dev)
    for a in range(0, k, per):
        b = min(a + per, k)
        samples = tracer.trace(pix[a:b].repeat_interleave(n), gen).reshape(b - a, n, 3)
        s[a:b] = samples.sum(1)
        x = samples.double()
        m[a:b] = x.mean(1)
        v[a:b] = x.var(1) if n > 1 else torch.zeros_like(m[a:b])
    return s, m, v
