"""Numerical utilities: quadrature, root finding, splines, spherical
harmonics, von Mises-Fisher (port of mitsuba_tpu/core/numerics.py).

Rebuild of the reference's scattered numeric helpers
(reference: include/mitsuba/core/{quad.h:36-139, brent.h:38,
spline.h:41-178, sh.h:56-120, vmf.h:37}).  Host-side (numpy) for
precomputation tables; the spline evaluator also takes torch tensors, so
baked tables can be interpolated on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# quadrature (reference quad.h GaussLobattoIntegrator / gauss-legendre)
# ---------------------------------------------------------------------------

def gauss_legendre(n: int):
    """Nodes/weights on [-1, 1] (reference quad.h gaussLegendre)."""
    return np.polynomial.legendre.leggauss(n)


def integrate_gl(f, a: float, b: float, n: int = 64) -> float:
    """Fixed-order Gauss-Legendre integral of a scalar function."""
    x, w = gauss_legendre(n)
    xm, xr = 0.5 * (a + b), 0.5 * (b - a)
    return float(xr * np.sum(w * f(xm + xr * x)))


def integrate_simpson(f, a: float, b: float, n: int = 129) -> float:
    """Composite Simpson (reference quad.h NDIntegrator fallback)."""
    if n % 2 == 0:
        n += 1
    x = np.linspace(a, b, n)
    y = f(x)
    h = (b - a) / (n - 1)
    return float(h / 3.0 * (y[0] + y[-1] + 4 * y[1:-1:2].sum()
                            + 2 * y[2:-1:2].sum()))


# ---------------------------------------------------------------------------
# Brent's method (reference brent.h BrentSolver:38)
# ---------------------------------------------------------------------------

def brent(f, a: float, b: float, xtol: float = 1e-10,
          max_iters: int = 100) -> float:
    """Root of f in [a, b]; f(a), f(b) must bracket the root."""
    fa, fb = f(a), f(b)
    if fa * fb > 0:
        raise ValueError("brent: root not bracketed")
    if abs(fa) < abs(fb):
        a, b, fa, fb = b, a, fb, fa
    c, fc = a, fa
    d = e = b - a
    for _ in range(max_iters):
        if fb == 0.0 or abs(b - a) < xtol:
            return b
        if fa != fc and fb != fc:
            # inverse quadratic interpolation
            s = (
                a * fb * fc / ((fa - fb) * (fa - fc))
                + b * fa * fc / ((fb - fa) * (fb - fc))
                + c * fa * fb / ((fc - fa) * (fc - fb))
            )
        else:
            s = b - fb * (b - a) / (fb - fa)  # secant
        lo, hi = min((3 * a + b) / 4, b), max((3 * a + b) / 4, b)
        if not (lo < s < hi):
            s = 0.5 * (a + b)  # bisection fallback
        fs = f(s)
        c, fc = b, fb
        if fa * fs < 0:
            b, fb = s, fs
        else:
            a, fa = s, fs
        if abs(fa) < abs(fb):
            a, b, fa, fb = b, a, fb, fa
    return b


# ---------------------------------------------------------------------------
# Catmull-Rom / natural cubic splines (reference spline.h:41-178)
# ---------------------------------------------------------------------------

def spline_coeffs(x, values):
    """Natural cubic spline second-derivative table (1D)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(values, np.float64)
    n = len(x)
    m = np.zeros(n)
    u = np.zeros(n)
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * m[i - 1] + 2.0
        m[i] = (sig - 1.0) / p
        u[i] = (
            (y[i + 1] - y[i]) / (x[i + 1] - x[i])
            - (y[i] - y[i - 1]) / (x[i] - x[i - 1])
        )
        u[i] = (6.0 * u[i] / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    for i in range(n - 2, -1, -1):
        m[i] = m[i] * m[i + 1] + u[i]
    return m


def spline_eval(x, values, m, xq):
    """Evaluate the natural cubic spline at xq: a numpy array, or a
    torch tensor, in which case the table goes to its device and dtype."""
    if torch.is_tensor(xq):
        x = torch.as_tensor(np.asarray(x), dtype=xq.dtype, device=xq.device)
        y = torch.as_tensor(np.asarray(values), dtype=xq.dtype, device=xq.device)
        m = torch.as_tensor(np.asarray(m), dtype=xq.dtype, device=xq.device)
        i = torch.clamp(torch.searchsorted(x, xq.contiguous()) - 1, 0, len(values) - 2)
    else:
        x, y, m = np.asarray(x), np.asarray(values), np.asarray(m)
        i = np.clip(np.searchsorted(x, xq) - 1, 0, len(values) - 2)
    h = x[i + 1] - x[i]
    a = (x[i + 1] - xq) / h
    b = (xq - x[i]) / h
    return (
        a * y[i] + b * y[i + 1]
        + ((a**3 - a) * m[i] + (b**3 - b) * m[i + 1]) * (h * h) / 6.0
    )


# ---------------------------------------------------------------------------
# real spherical harmonics (reference sh.h SHVector:56)
# ---------------------------------------------------------------------------

def sh_eval(l_max: int, d):
    """Real SH basis values up to band l_max (ARBITRARY order) at unit
    directions d [..., 3].  Returns [..., (l_max+1)^2] (numpy), index
    layout l*(l+1)+m, Condon-Shortley real basis (reference
    shvector.h:56 SHVector::eval).

    Division-free recurrences: C_m = r^m cos(m phi), S_m = r^m
    sin(m phi) build from (x, y); the associated Legendre part is
    carried as P~_lm = P_lm / r^m (a pure polynomial in z), so poles
    (r = 0) are exact."""
    d = np.asarray(d, np.float64)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    n_coeff = (l_max + 1) ** 2
    out = np.zeros(d.shape[:-1] + (n_coeff,))

    # C_m, S_m recurrence (C_0 = 1, S_0 = 0)
    c_m = [np.ones_like(x)]
    s_m = [np.zeros_like(x)]
    for m in range(1, l_max + 1):
        c_m.append(x * c_m[m - 1] - y * s_m[m - 1])
        s_m.append(x * s_m[m - 1] + y * c_m[m - 1])

    # P~_lm recurrence per m-diagonal
    pt = {}
    pmm = np.ones_like(z)
    for m in range(0, l_max + 1):
        pt[(m, m)] = pmm.copy() if m else np.ones_like(z)
        if m + 1 <= l_max:
            pt[(m + 1, m)] = z * (2 * m + 1) * pt[(m, m)]
        for ll in range(m + 2, l_max + 1):
            pt[(ll, m)] = (
                (2 * ll - 1) * z * pt[(ll - 1, m)]
                - (ll + m - 1) * pt[(ll - 2, m)]
            ) / (ll - m)
        # next diagonal: P~_{m+1,m+1} = -(2m+1) * P~_mm  (the r factor
        # is absorbed into C/S)
        pmm = -(2 * m + 1) * pt[(m, m)]

    import math as _math

    for ll in range(l_max + 1):
        for m in range(ll + 1):
            k = _math.sqrt(
                (2 * ll + 1)
                / (4 * _math.pi)
                * _math.factorial(ll - m)
                / _math.factorial(ll + m)
            )
            if m == 0:
                out[..., ll * (ll + 1)] = k * pt[(ll, 0)]
            else:
                sq2k = _math.sqrt(2.0) * k
                out[..., ll * (ll + 1) + m] = (
                    sq2k * c_m[m] * pt[(ll, m)]
                )
                out[..., ll * (ll + 1) - m] = (
                    sq2k * s_m[m] * pt[(ll, m)]
                )
    return out


def sh_project(l_max: int, f, n_samples: int = 10000, seed: int = 0):
    """MC-project a function of direction onto SH coefficients."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(n_samples, 2))
    z = 1.0 - 2.0 * u[:, 0]
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    phi = 2 * np.pi * u[:, 1]
    d = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)
    basis = sh_eval(l_max, d)
    vals = f(d)
    return 4 * np.pi * np.mean(vals[:, None] * basis, axis=0)


class SHSampler:
    """Importance sampler for an SH expansion (reference shvector.h:430
    SHSampler: hierarchical warping over a 2^depth x 2^depth (theta,
    phi) grid).  Rebuild: the per-cell |f| masses become a dense 2D
    CDF table sampled with two searchsorted's — the vectorized
    equivalent of the reference's per-sample hierarchy descent (whose
    resolution and piecewise-constant pdf this matches exactly).
    """

    def __init__(self, coeffs, depth: int = 6, quad: int = 4):
        coeffs = np.asarray(coeffs, np.float64)
        l_max = int(np.sqrt(coeffs.shape[0])) - 1
        n = 1 << depth
        self.n = n
        # cell-averaged |f| via midpoint quadrature (quad^2 points/cell)
        tq = (np.arange(n * quad) + 0.5) / (n * quad) * np.pi
        pq = (np.arange(n * quad) + 0.5) / (n * quad) * 2 * np.pi
        tt, pp = np.meshgrid(tq, pq, indexing="ij")
        dirs = np.stack(
            [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
             np.cos(tt)], -1,
        )
        f = sh_eval(l_max, dirs.reshape(-1, 3)) @ coeffs
        f = np.abs(f).reshape(n, quad, n, quad).mean(axis=(1, 3))
        # cell mass = avg|f| * cell solid angle
        edges = np.arange(n + 1) / n * np.pi
        sa_theta = np.cos(edges[:-1]) - np.cos(edges[1:])
        mass = f * sa_theta[:, None] * (2 * np.pi / n)
        self.total = float(mass.sum())
        self.mass = mass
        row = mass.sum(axis=1)
        self.row_cdf = np.concatenate([[0.0], np.cumsum(row)])
        self.row_cdf /= max(self.row_cdf[-1], 1e-300)
        cond = np.cumsum(mass, axis=1)
        cond = np.concatenate([np.zeros((n, 1)), cond], axis=1)
        cond /= np.maximum(cond[:, -1:], 1e-300)
        self.cond_cdf = cond

    def sample(self, u):
        """u [N, 2] -> (directions [N, 3], pdf [N] wrt solid angle)."""
        u = np.asarray(u, np.float64)
        n = self.n
        i = np.clip(
            np.searchsorted(self.row_cdf, u[:, 0], side="right") - 1,
            0, n - 1,
        )
        # stratified reuse within the row
        lo, hi = self.row_cdf[i], self.row_cdf[i + 1]
        u0 = (u[:, 0] - lo) / np.maximum(hi - lo, 1e-300)
        cc = self.cond_cdf[i]
        j = np.clip(
            (cc <= u[:, 1][:, None]).sum(axis=1) - 1, 0, n - 1
        )
        lo2 = cc[np.arange(len(i)), j]
        hi2 = cc[np.arange(len(i)), j + 1]
        u1 = (u[:, 1] - lo2) / np.maximum(hi2 - lo2, 1e-300)
        # uniform within the cell, exact in solid angle for theta
        ct0 = np.cos(i / n * np.pi)
        ct1 = np.cos((i + 1) / n * np.pi)
        ct = ct0 + (ct1 - ct0) * u0
        st = np.sqrt(np.maximum(1 - ct * ct, 0.0))
        phi = (j + u1) / n * 2 * np.pi
        d = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)
        return d, self.pdf_cell(i, j)

    def pdf_cell(self, i, j):
        edges0 = np.cos(i / self.n * np.pi)
        edges1 = np.cos((i + 1) / self.n * np.pi)
        sa = (edges0 - edges1) * (2 * np.pi / self.n)
        return self.mass[i, j] / max(self.total, 1e-300) / np.maximum(
            sa, 1e-300
        )

    def pdf(self, d):
        d = np.asarray(d, np.float64)
        theta = np.arccos(np.clip(d[..., 2], -1, 1))
        phi = np.arctan2(d[..., 1], d[..., 0]) % (2 * np.pi)
        i = np.clip(
            (theta / np.pi * self.n).astype(np.int64), 0, self.n - 1
        )
        j = np.clip(
            (phi / (2 * np.pi) * self.n).astype(np.int64), 0, self.n - 1
        )
        return self.pdf_cell(i, j)


# ---------------------------------------------------------------------------
# von Mises-Fisher (reference vmf.h:37)
# ---------------------------------------------------------------------------

def vmf_pdf(kappa: float, cos_theta):
    """vMF density wrt solid angle (axis at +z)."""
    cos_theta = np.asarray(cos_theta)
    if kappa < 1e-6:
        return np.full_like(cos_theta, 1.0 / (4 * np.pi))
    return (
        kappa / (2 * np.pi * (1 - np.exp(-2 * kappa)))
        * np.exp(kappa * (cos_theta - 1))
    )


def vmf_fit(mean_cos: float) -> float:
    """Concentration from the mean resultant length (Banerjee et al.
    approximation, = vmf.h forMeanCosine)."""
    r = float(np.clip(mean_cos, 0.0, 0.9999))
    return r * (3.0 - r * r) / (1.0 - r * r)


def vmf_sample(kappa: float, u2):
    """Sample directions around +z (numpy)."""
    u2 = np.asarray(u2)
    if kappa < 1e-6:
        cos_t = 1.0 - 2.0 * u2[..., 0]
    else:
        cos_t = 1.0 + np.log1p(
            np.expm1(-2.0 * kappa) * u2[..., 0]
        ) / kappa
    sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
    phi = 2 * np.pi * u2[..., 1]
    return np.stack(
        [sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], axis=-1
    )
