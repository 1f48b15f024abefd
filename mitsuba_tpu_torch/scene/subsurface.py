"""Subsurface scattering plugins: the classical isotropic dipole BSSRDF
and fast single scattering (port of mitsuba_tpu/scene/subsurface.py,
reference src/subsurface/dipole.cpp and singlescatter.cpp).

Host-side only (numpy): the measured material presets, the dipole
coefficients, and the area-stratified point set on which the
irradiance pass (integrator/sss.py) estimates E.  The point set comes
from numpy's `default_rng(0x5551F)` with the reference's density, cap
(MTS_SSS_MAX_POINTS) and rounding to a multiple of 64, so the port packs
the reference's points bit for bit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.scene.registry import register

# Measured translucent materials (Jensen et al. 2001, "A Practical Model
# for Subsurface Light Transport", Table 1): sigma_s' and sigma_a in
# 1/mm, and eta
SSS_PRESETS = {
    "apple": ((2.29, 2.39, 1.97), (0.0030, 0.0034, 0.046), 1.3),
    "chicken1": ((0.15, 0.21, 0.38), (0.015, 0.077, 0.19), 1.3),
    "chicken2": ((0.19, 0.25, 0.32), (0.018, 0.088, 0.20), 1.3),
    "cream": ((7.38, 5.47, 3.15), (0.0002, 0.0028, 0.0163), 1.3),
    "ketchup": ((0.18, 0.07, 0.03), (0.061, 0.97, 1.45), 1.3),
    "marble": ((2.19, 2.62, 3.00), (0.0021, 0.0041, 0.0071), 1.5),
    "potato": ((0.68, 0.70, 0.55), (0.0024, 0.0090, 0.12), 1.3),
    "skimmilk": ((0.70, 1.22, 1.90), (0.0014, 0.0025, 0.0142), 1.3),
    "wholemilk": ((2.55, 3.21, 3.77), (0.0011, 0.0024, 0.014), 1.3),
    "skin1": ((0.74, 0.88, 1.01), (0.032, 0.17, 0.48), 1.3),
    "skin2": ((1.09, 1.59, 1.79), (0.013, 0.070, 0.145), 1.4),
    "spectralon": ((11.6, 20.4, 14.9), (0.0, 0.0, 0.0), 1.3),
}

# cap on a shape's point count (the dense sum's cost grows with it)
DEFAULT_MAX_POINTS = 16384


def fresnel_diffuse_reflectance(eta: float) -> float:
    """The Egan & Hilgeman fit the dipole reads (reference
    libcore/util.cpp fresnelDiffuseReflectance, approximate branch), in
    float64."""
    if eta < 1.0:
        return float(-0.4399 + 0.7099 / eta - 0.3319 / eta**2 + 0.0636 / eta**3)
    return float(-1.4399 / (eta * eta) + 0.7099 / eta + 0.6681 + 0.0636 * eta)


@dataclass
class SubsurfaceRecord:
    """Dipole / single-scattering parameters (reference dipole.cpp:configure)."""

    # the (not reduced) scattering and the absorption coefficients
    sigma_s: np.ndarray = field(default_factory=lambda: np.full(3, 1.0, np.float32))
    sigma_a: np.ndarray = field(default_factory=lambda: np.full(3, 0.05, np.float32))
    g: float = 0.0
    eta: float = 1.3
    scale: float = 1.0
    irr_samples: int = 16
    indirect: bool = True
    sample_multiplier: float = 1.0
    # "dipole" (the diffusion query) or "singlescatter"
    kind: str = "dipole"
    ss_samples: int = 2  # distance samples along the refracted ray
    ss_depth: int = 4  # internal-reflection bounces (singleScatterDepth)

    def dipole_coefficients(self):
        """(zr [3], zv [3], sigma_tr [3] float32, min mean free path),
        computed in float64 after `scale`."""
        sigma_sp = np.asarray(self.sigma_s, np.float64) * (1.0 - self.g) * self.scale
        sigma_a = np.asarray(self.sigma_a, np.float64) * self.scale
        sigma_tp = np.maximum(sigma_sp + sigma_a, 1e-8)
        mfp = 1.0 / sigma_tp
        fdr = fresnel_diffuse_reflectance(1.0 / self.eta)
        a_coeff = (1.0 + fdr) / (1.0 - fdr)
        sigma_tr = np.sqrt(3.0 * sigma_a * sigma_tp)
        zr = mfp
        zv = mfp * (1.0 + 4.0 / 3.0 * a_coeff)
        return (zr.astype(np.float32), zv.astype(np.float32), sigma_tr.astype(np.float32),
                float(mfp.min()))


class _SubsurfaceBase:
    def __init__(self, props):
        self.props = props
        rec = SubsurfaceRecord()
        mat = props.get_string("material", "")
        if mat:
            if mat not in SSS_PRESETS:
                raise ValueError(
                    f"subsurface: unknown material '{mat}' (have {sorted(SSS_PRESETS)})"
                )
            sp, sa, eta = SSS_PRESETS[mat]
            rec.sigma_s = np.asarray(sp, np.float32)  # already reduced
            rec.sigma_a = np.asarray(sa, np.float32)
            rec.g = 0.0
            rec.eta = eta
        if "sigmaS" in props or "sigmaA" in props:
            rec.sigma_s = props.get_spectrum("sigmaS", np.full(3, 1.0)).astype(np.float32)
            rec.sigma_a = props.get_spectrum("sigmaA", np.full(3, 0.05)).astype(np.float32)
        elif "sigmaT" in props and "albedo" in props:
            st = props.get_spectrum("sigmaT")
            al = props.get_spectrum("albedo")
            rec.sigma_s = (st * al).astype(np.float32)
            rec.sigma_a = (st * (1.0 - al)).astype(np.float32)
        rec.g = props.get_float("g", rec.g)
        int_ior = props.get_float("intIOR", None)
        ext_ior = props.get_float("extIOR", None)
        if int_ior is not None or ext_ior is not None:
            rec.eta = (int_ior or 1.5046) / (ext_ior or 1.000277)
        rec.scale = props.get_float("scale", 1.0)
        rec.irr_samples = props.get_int("irrSamples", 16)
        rec.indirect = props.get_bool("irrIndirect", True)
        rec.sample_multiplier = props.get_float("sampleMultiplier", 1.0)
        self.record = rec


def sample_surface_points(meshes, spheres, rec: SubsurfaceRecord):
    """The area-stratified point set of one shape (the reference's
    blueNoisePointSet at actualRadius = min_mfp / sqrt(sampleMultiplier *
    20), dipole.cpp:preprocess): twice the points a disk of that radius
    per point would need, at least 256, at most MTS_SSS_MAX_POINTS,
    rounded up to a multiple of 64.  Returns (pts [N, 3], nrm [N, 3]
    float32, area per point, whether the cap bound)."""
    _, _, _, min_mfp = rec.dipole_coefficients()
    r_act = min_mfp / np.sqrt(max(rec.sample_multiplier, 1e-3) * 20.0)

    v0l, v1l, v2l = [], [], []
    for mesh in meshes:
        p = mesh.positions
        i = mesh.indices.astype(np.int64)
        v0l.append(p[i[:, 0]])
        v1l.append(p[i[:, 1]])
        v2l.append(p[i[:, 2]])
    if v0l:
        v0, v1, v2 = np.concatenate(v0l), np.concatenate(v1l), np.concatenate(v2l)
        cross = np.cross(v1 - v0, v2 - v0)
        tri_area = 0.5 * np.linalg.norm(cross, axis=-1)
        tri_n = cross / np.maximum(np.linalg.norm(cross, axis=-1, keepdims=True), 1e-20)
    else:
        tri_area = np.zeros(0)
    sph_area = np.array([4.0 * np.pi * s.radius**2 for s in spheres])
    sa = float(tri_area.sum() + sph_area.sum())
    if sa <= 0:
        raise ValueError("subsurface: shape has zero surface area")

    cap = int(os.environ.get("MTS_SSS_MAX_POINTS", str(DEFAULT_MAX_POINTS)))
    n_want = int(sa / (np.pi * r_act * r_act) * 2.0)
    n = int(np.clip(n_want, 256, cap))
    n = ((n + 63) // 64) * 64
    rng = np.random.default_rng(0x5551F)

    # points over triangles and spheres in proportion to their area
    all_areas = np.concatenate([tri_area, sph_area])
    pick = rng.choice(len(all_areas), size=n, p=all_areas / sa)
    pts = np.zeros((n, 3), np.float32)
    nrm = np.zeros((n, 3), np.float32)
    is_tri = pick < len(tri_area)
    if is_tri.any():
        t = pick[is_tri]
        u = rng.uniform(size=(is_tri.sum(), 2))
        su = np.sqrt(u[:, 0:1])
        b1 = 1.0 - su
        b2 = u[:, 1:2] * su
        pts[is_tri] = (v0[t] * (1 - b1 - b2) + v1[t] * b1 + v2[t] * b2).astype(np.float32)
        nrm[is_tri] = tri_n[t]
    if (~is_tri).any():
        s_idx = pick[~is_tri] - len(tri_area)
        u = rng.uniform(size=((~is_tri).sum(), 2))
        z = 1.0 - 2.0 * u[:, 0]
        r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
        phi = 2 * np.pi * u[:, 1]
        d = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)
        centers = np.stack([spheres[k].center for k in s_idx])
        radii = np.array([spheres[k].radius for k in s_idx])[:, None]
        pts[~is_tri] = (centers + d * radii).astype(np.float32)
        nrm[~is_tri] = d.astype(np.float32)
    return pts, nrm, sa / n, n_want > cap


@register("subsurface", "dipole")
class Dipole(_SubsurfaceBase):
    """The diffusion query over the irradiance point set
    (integrator/sss.py sss_lo)."""


@register("subsurface", "singlescatter")
class SingleScatter(_SubsurfaceBase):
    """Single scattering along the refracted camera ray, the reference's
    fastSingleScatter branch (singlescatter.cpp LoSingle:1326-1480), with
    its internal-reflection loop up to singleScatterDepth (:137-138,
    :1378-1400); integrator/sss.py single_scatter_lo.  The refracted
    connection solver is not in the reference either."""

    def __init__(self, props):
        super().__init__(props)
        self.record.kind = "singlescatter"
        self.record.ss_samples = props.get_int("fastSingleScatterSamples", 2)
        self.record.ss_depth = props.get_int("singleScatterDepth", 4)
