"""BSDF plugins (port of mitsuba_tpu/bsdf/plugins.py): `diffuse`,
`conductor`, `roughconductor`, `dielectric`, `roughdielectric`,
`plastic`, `roughplastic` and `null` (an index-matched boundary), with reflectances that may be textures
(scene/textures.py).  Each parses `Properties` into a `BSDFRecord`, which
the scene builder packs into the material table."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.bsdf import ior as iordb
from mitsuba_tpu_torch.bsdf.microfacet import BECKMANN, GGX, PHONG
from mitsuba_tpu_torch.scene.registry import register
from mitsuba_tpu_torch.scene.textures import TEX_CONSTANT, TextureDesc, as_texture_or_spectrum

# material types, as numbered in the reference
DIFFUSE = 0
CONDUCTOR = 2
ROUGHCONDUCTOR = 3
DIELECTRIC = 4
ROUGHDIELECTRIC = 6
PLASTIC = 7
ROUGHPLASTIC = 8
NULL_BSDF = 12

_DISTS = {"beckmann": BECKMANN, "ggx": GGX, "phong": PHONG, "as": BECKMANN}


def _gray(v):
    return np.full(3, v, np.float32)


@dataclass
class BSDFRecord:
    type: int = DIFFUSE
    cA: np.ndarray = field(default_factory=lambda: _gray(0.5))  # diffuse refl
    cB: np.ndarray = field(default_factory=lambda: _gray(1.0))  # specular refl
    cC: np.ndarray = field(default_factory=lambda: _gray(1.0))  # spec trans / eta
    cD: np.ndarray = field(default_factory=lambda: _gray(0.0))  # conductor k
    texA: TextureDesc | None = None  # texture behind cA
    alpha_u: float = 0.1
    alpha_v: float = 0.1
    eta: float = 1.5046  # int_ior / ext_ior
    exponent: float = 30.0
    dist: int = BECKMANN
    nonlinear: bool = False
    twosided: bool = False
    # plastic precompute
    fdr_int: float = 0.0
    spec_sampling_weight: float = 0.5
    id: str = ""


class _BSDFBase:
    def __init__(self, props):
        self.props = props
        self.record = self._build(props)
        if props.id:
            self.record.id = props.id

    def _build(self, props) -> BSDFRecord:
        raise NotImplementedError


def _textured(tex):
    return tex if tex.kind != TEX_CONSTANT else None


def _ior_pair(props, int_default="bk7", ext_default="air"):
    int_ior = iordb.lookup_dielectric(props.raw("intIOR") if "intIOR" in props else int_default)
    ext_ior = iordb.lookup_dielectric(props.raw("extIOR") if "extIOR" in props else ext_default)
    if int_ior <= 0 or ext_ior <= 0:
        raise ValueError("IORs must be positive")
    return int_ior / ext_ior


def _alpha(props, rec, default=0.1):
    """alpha (isotropic) or alphaU/alphaV, and the distribution.  As in
    the reference, a texture child named alpha is not read."""
    if "alpha" in props:
        rec.alpha_u = rec.alpha_v = float(props.get_spectrum("alpha").mean())
    else:
        rec.alpha_u = props.get_float("alphaU", default)
        rec.alpha_v = props.get_float("alphaV", default)
    rec.dist = _DISTS[props.get_string("distribution", "beckmann")]


def _fdr_exact(eta: float) -> float:
    """Diffuse Fresnel reflectance by numerical integration (the
    reference's Gauss-Lobatto path, src/libcore/util.cpp:856)."""
    x = np.linspace(0.0, 1.0, 4097)
    ct = np.sqrt(x)
    sin2t = (1 - ct * ct) / (eta * eta)
    tir = sin2t >= 1.0
    ctt = np.sqrt(np.maximum(1 - sin2t, 0.0))
    rs = (ct - eta * ctt) / np.maximum(ct + eta * ctt, 1e-12)
    rp = (eta * ct - ctt) / np.maximum(eta * ct + ctt, 1e-12)
    F = np.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    return float(np.trapezoid(F, x))


@register("bsdf", "diffuse")
class Diffuse(_BSDFBase):
    """reference: src/bsdfs/diffuse.cpp"""

    def _build(self, props):
        tex = as_texture_or_spectrum(props, "reflectance", _gray(0.5))
        return BSDFRecord(type=DIFFUSE, cA=tex.average(), texA=_textured(tex))


@register("bsdf", "conductor")
class Conductor(_BSDFBase):
    """reference: src/bsdfs/conductor.cpp (default material Cu, :159)."""

    def _build(self, props):
        rec = BSDFRecord(type=CONDUCTOR)
        if "eta" in props and "k" in props:
            rec.cC = props.get_spectrum("eta")
            rec.cD = props.get_spectrum("k")
        else:
            eta, k = iordb.lookup_conductor(props.get_string("material", "Cu"))
            rec.cC, rec.cD = np.asarray(eta), np.asarray(k)
        ext = iordb.lookup_dielectric(props.raw("extEta") if "extEta" in props else "air")
        rec.cC = (rec.cC / ext).astype(np.float32)
        rec.cD = (rec.cD / ext).astype(np.float32)
        rec.cB = as_texture_or_spectrum(props, "specularReflectance", _gray(1.0)).average()
        return rec


@register("bsdf", "roughconductor")
class RoughConductor(Conductor):
    """reference: src/bsdfs/roughconductor.cpp"""

    def _build(self, props):
        rec = super()._build(props)
        rec.type = ROUGHCONDUCTOR
        _alpha(props, rec)
        return rec


@register("bsdf", "dielectric")
class Dielectric(_BSDFBase):
    """reference: src/bsdfs/dielectric.cpp"""

    def _build(self, props):
        rec = BSDFRecord(type=DIELECTRIC)
        rec.eta = _ior_pair(props)
        rec.cB = as_texture_or_spectrum(props, "specularReflectance", _gray(1.0)).average()
        rec.cC = as_texture_or_spectrum(props, "specularTransmittance", _gray(1.0)).average()
        return rec


@register("bsdf", "roughdielectric")
class RoughDielectric(Dielectric):
    """reference: src/bsdfs/roughdielectric.cpp"""

    def _build(self, props):
        rec = super()._build(props)
        rec.type = ROUGHDIELECTRIC
        _alpha(props, rec)
        return rec


@register("bsdf", "plastic")
class Plastic(_BSDFBase):
    """reference: src/bsdfs/plastic.cpp: a smooth dielectric coat over a
    diffuse base with internal-scattering compensation (fdrInt)."""

    def _build(self, props):
        rec = BSDFRecord(type=PLASTIC)
        rec.eta = _ior_pair(props, int_default="polypropylene")
        tex = as_texture_or_spectrum(props, "diffuseReflectance", _gray(0.5))
        rec.cA = tex.average()
        rec.texA = _textured(tex)
        rec.cB = as_texture_or_spectrum(props, "specularReflectance", _gray(1.0)).average()
        rec.nonlinear = props.get_bool("nonlinear", False)
        rec.fdr_int = _fdr_exact(1.0 / rec.eta)
        d_avg = float(rec.cA.mean())
        s_avg = float(rec.cB.mean())
        rec.spec_sampling_weight = s_avg / max(s_avg + d_avg, 1e-8)
        return rec


@register("bsdf", "roughplastic")
class RoughPlastic(Plastic):
    """reference: src/bsdfs/roughplastic.cpp"""

    def _build(self, props):
        rec = super()._build(props)
        rec.type = ROUGHPLASTIC
        _alpha(props, rec)
        return rec


@register("bsdf", "null")
class NullBSDF(_BSDFBase):
    """reference: src/bsdfs/null.cpp (a medium's index-matched boundary:
    rays pass straight through)."""

    def _build(self, props):
        return BSDFRecord(type=NULL_BSDF)
