"""BSDF plugins (port of mitsuba_tpu/bsdf/plugins.py): `diffuse`,
`roughdiffuse`, `conductor`, `roughconductor`, `dielectric`,
`thindielectric`, `roughdielectric`, `plastic`, `roughplastic`, `phong`,
`ward`, `difftrans`, `hk`, `null` (an index-matched boundary), the
folded wrappers `twosided` (a flag) and `mask` (an opacity that, as in
the reference, nothing reads), the mixtures `mixturebsdf` and
`blendbsdf`, the layers `coating` and `roughcoating`, the folded
perturbations `bumpmap` and `normalmap` (a texture slot of a copy of the
nested record, read by scene/texture_eval.py shading_frame), and the
woven cloth `irawan` (bsdf/irawan.py), with reflectances that may be
textures (scene/textures.py).  Each parses `Properties` into a
`BSDFRecord`, which the scene builder packs into the material table."""

from __future__ import annotations

from dataclasses import dataclass, field

import copy

import numpy as np

from mitsuba_tpu_torch.bsdf import ior as iordb
from mitsuba_tpu_torch.bsdf.microfacet import BECKMANN, GGX, PHONG
from mitsuba_tpu_torch.scene.registry import register
from mitsuba_tpu_torch.scene.textures import TEX_CONSTANT, TextureDesc, as_texture_or_spectrum

# material types, as numbered in the reference
DIFFUSE = 0
ROUGHDIFFUSE = 1
CONDUCTOR = 2
ROUGHCONDUCTOR = 3
DIELECTRIC = 4
THINDIELECTRIC = 5
ROUGHDIELECTRIC = 6
PLASTIC = 7
ROUGHPLASTIC = 8
PHONG_BSDF = 9
WARD = 10
DIFFTRANS = 11
NULL_BSDF = 12
MIXTURE = 13
COATING = 14
HK = 15
ROUGHCOATING = 16
IRAWAN = 17

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
    dispersion: float = 0.0  # Cauchy B [um^2]; spectral mode only
    exponent: float = 30.0
    dist: int = BECKMANN
    nonlinear: bool = False
    twosided: bool = False
    opacity: np.ndarray | None = None  # folded <mask>
    tex_opacity: TextureDesc | None = None
    # folded bumpmap / normalmap: the height or normal texture
    tex_bump: TextureDesc | None = None
    bump_is_normalmap: bool = False
    # plastic precompute
    fdr_int: float = 0.0
    spec_sampling_weight: float = 0.5
    # mixtures and layers: the nested records (and a mixture's weights)
    children: list = field(default_factory=list)
    weights: list = field(default_factory=list)
    # irawan: the parsed weave pattern, its tiling and its specular
    # normalization
    weave: object = None
    repeat_u: float = 1.0
    repeat_v: float = 1.0
    iw_norm: float = 0.0
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


@register("bsdf", "roughdiffuse")
class RoughDiffuse(_BSDFBase):
    """reference: src/bsdfs/roughdiffuse.cpp (Oren-Nayar, the fast
    approximation; sigma = alpha / sqrt(2), roughdiffuse.cpp:139)."""

    def _build(self, props):
        tex = as_texture_or_spectrum(props, "reflectance", _gray(0.5))
        rec = BSDFRecord(type=ROUGHDIFFUSE, cA=tex.average(), texA=_textured(tex))
        rec.alpha_u = rec.alpha_v = float(as_texture_or_spectrum(props, "alpha", 0.2)
                                          .average().mean())
        return rec


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
        # wavelength-dependent IOR for N-bin spectral renders
        # (core/spectral.py cauchy_eta); ignored in RGB mode
        rec.dispersion = props.get_float("dispersion", 0.0)
        rec.cB = as_texture_or_spectrum(props, "specularReflectance", _gray(1.0)).average()
        rec.cC = as_texture_or_spectrum(props, "specularTransmittance", _gray(1.0)).average()
        return rec


@register("bsdf", "thindielectric")
class ThinDielectric(Dielectric):
    """reference: src/bsdfs/thindielectric.cpp"""

    def _build(self, props):
        rec = super()._build(props)
        rec.type = THINDIELECTRIC
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


def _glossy(props, typ):
    """A diffuse base with a glossy lobe (phong, ward): the two colours
    and the sampling weight of the glossy lobe, sAvg / (sAvg + dAvg)."""
    tex = as_texture_or_spectrum(props, "diffuseReflectance", _gray(0.5))
    rec = BSDFRecord(type=typ, cA=tex.average(), texA=_textured(tex))
    rec.cB = as_texture_or_spectrum(props, "specularReflectance", _gray(0.2)).average()
    d_avg, s_avg = float(rec.cA.mean()), float(rec.cB.mean())
    rec.spec_sampling_weight = s_avg / max(s_avg + d_avg, 1e-8)
    return rec


@register("bsdf", "phong")
class Phong(_BSDFBase):
    """reference: src/bsdfs/phong.cpp (the modified Phong model)."""

    def _build(self, props):
        rec = _glossy(props, PHONG_BSDF)
        rec.exponent = props.get_float("exponent", 30.0)
        return rec


@register("bsdf", "ward")
class Ward(_BSDFBase):
    """reference: src/bsdfs/ward.cpp (the balanced variant)."""

    def _build(self, props):
        rec = _glossy(props, WARD)
        rec.alpha_u = props.get_float("alphaU", props.get_float("alpha", 0.1))
        rec.alpha_v = props.get_float("alphaV", props.get_float("alpha", 0.1))
        return rec


@register("bsdf", "difftrans")
class DiffTrans(_BSDFBase):
    """reference: src/bsdfs/difftrans.cpp"""

    def _build(self, props):
        tex = as_texture_or_spectrum(props, "transmittance", _gray(0.5))
        return BSDFRecord(type=DIFFTRANS, cA=tex.average(), texA=_textured(tex))


@register("bsdf", "null")
class NullBSDF(_BSDFBase):
    """reference: src/bsdfs/null.cpp (a medium's index-matched boundary:
    rays pass straight through)."""

    def _build(self, props):
        return BSDFRecord(type=NULL_BSDF)


def _nested_bsdfs(props):
    return [child.record for _, child in props.children
            if isinstance(getattr(child, "record", None), BSDFRecord)]


def _first_nested(props, name):
    nested = _nested_bsdfs(props)
    if not nested:
        raise ValueError(f"{name}: requires a nested BSDF")
    return nested[0]


@register("bsdf", "twosided")
class TwoSided(_BSDFBase):
    """reference: src/bsdfs/twosided.cpp, folded into a flag of a copy of
    the nested record (bsdf/eval.py _flip_twosided)."""

    def _build(self, props):
        rec = copy.deepcopy(_first_nested(props, "twosided"))
        rec.twosided = True
        return rec


@register("bsdf", "mask")
class Mask(_BSDFBase):
    """reference: src/bsdfs/mask.cpp, folded into an opacity of a copy of
    the nested record.  As in the reference, the builder packs it and
    nothing reads it: a masked BSDF renders opaque (ROADMAP C3)."""

    def _build(self, props):
        rec = copy.deepcopy(_first_nested(props, "mask"))
        op = as_texture_or_spectrum(props, "opacity", _gray(0.5))
        rec.opacity = op.average()
        rec.tex_opacity = _textured(op)
        return rec


@register("bsdf", "bumpmap")
class BumpMap(_BSDFBase):
    """reference: src/bsdfs/bumpmap.cpp, folded into a height-texture slot
    of a copy of the nested record (texture_eval.shading_frame perturbs
    the normal)."""

    def _build(self, props):
        rec = copy.deepcopy(_first_nested(props, "bumpmap"))
        for _, child in props.children:
            if getattr(child, "desc", None) is not None:
                rec.tex_bump = child.desc
        return rec


@register("bsdf", "normalmap")
class NormalMap(BumpMap):
    """reference: src/bsdfs/normalmap.cpp: the slot holds a tangent-space
    normal texture."""

    def _build(self, props):
        rec = super()._build(props)
        rec.bump_is_normalmap = True
        return rec


@register("bsdf", "mixturebsdf")
class MixtureBSDF(_BSDFBase):
    """reference: src/bsdfs/mixturebsdf.cpp: N components with weights
    summing to at most one (the deficit is absorbed); the builder packs
    it as a chain of rows."""

    def _build(self, props):
        rec = BSDFRecord(type=MIXTURE, children=_nested_bsdfs(props))
        w = [float(x) for x in props.get_string("weights", "").split()]
        if len(w) != len(rec.children):
            raise ValueError("mixturebsdf: weight count must match nested BSDF count")
        if sum(w) > 1.0 + 1e-4:
            raise ValueError("mixturebsdf: weights sum to more than one")
        rec.weights = w
        return rec


@register("bsdf", "blendbsdf")
class BlendBSDF(_BSDFBase):
    """reference: src/bsdfs/blendbsdf.cpp: two BSDFs mixed by a weight (a
    texture's average where it is one)."""

    def _build(self, props):
        rec = BSDFRecord(type=MIXTURE, children=_nested_bsdfs(props))
        if len(rec.children) != 2:
            raise ValueError("blendbsdf: requires exactly two nested BSDFs")
        w = float(as_texture_or_spectrum(props, "weight", 0.5).average().mean())
        rec.weights = [1.0 - w, w]
        return rec


def _layer(props, typ, name):
    """A dielectric layer over a nested BSDF: its IOR ratio, specular
    reflectance, sigmaA x thickness (cD) and the sampling weight of its
    reflection, 1 / (1 + the nested record's average cA)."""
    nested = _first_nested(props, name)
    rec = BSDFRecord(type=typ, children=[nested])
    rec.eta = _ior_pair(props)
    rec.cB = props.get_spectrum("specularReflectance", np.ones(3)).astype(np.float32)
    thickness = props.get_float("thickness", 1.0)
    rec.cD = (np.asarray(props.get_spectrum("sigmaA", np.zeros(3))) * thickness).astype(
        np.float32)
    rec.spec_sampling_weight = 1.0 / max(1.0 + float(np.asarray(nested.cA).mean()), 1e-8)
    return rec


@register("bsdf", "coating")
class Coating(_BSDFBase):
    """reference: src/bsdfs/coating.cpp: a smooth dielectric layer over a
    nested BSDF (bsdf/eval.py _coating_*)."""

    def _build(self, props):
        return _layer(props, COATING, "coating")


@register("bsdf", "roughcoating")
class RoughCoating(_BSDFBase):
    """reference: src/bsdfs/roughcoating.cpp: a microfacet dielectric
    layer over a nested BSDF, isotropic only (roughcoating.cpp:144-146)
    (bsdf/eval.py _rcoating_*)."""

    def _build(self, props):
        rec = _layer(props, ROUGHCOATING, "roughcoating")
        _alpha(props, rec, default=0.1)
        rec.alpha_v = rec.alpha_u
        return rec


@register("bsdf", "hk")
class HanrahanKrueger(_BSDFBase):
    """reference: src/bsdfs/hk.cpp: a thin scattering slab (cB = sigmaS,
    cC = sigmaA, alpha_u = the HG g, flat or of a nested phase, alpha_v =
    the thickness, cA = the albedo)."""

    def _build(self, props):
        rec = BSDFRecord(type=HK)
        if "sigmaT" in props or "albedo" in props:
            sigma_t = props.get_spectrum("sigmaT", _gray(2.05))
            sigma_s = sigma_t * props.get_spectrum("albedo", _gray(2.0 / 2.05))
            sigma_a = sigma_t - sigma_s
        else:
            sigma_s = props.get_spectrum("sigmaS", _gray(2.0))
            sigma_a = props.get_spectrum("sigmaA", _gray(0.05))
        rec.cB = np.asarray(sigma_s, np.float32)
        rec.cC = np.asarray(sigma_a, np.float32)
        g = props.get_float("g", 0.0)
        for _, child in props.children:
            r = getattr(child, "record", None)
            if r is not None and hasattr(r, "g") and hasattr(r, "kind"):
                g = float(r.g)
        rec.alpha_u = g
        rec.alpha_v = props.get_float("thickness", 1.0)
        rec.cA = (sigma_s / np.maximum(sigma_s + sigma_a, 1e-6)).astype(np.float32)
        return rec


@register("bsdf", "irawan")
class IrawanCloth(_BSDFBase):
    """reference: src/bsdfs/irawan.{h,cpp}, the Irawan-Marschner woven
    cloth: a weave-pattern file (`filename`, with `$name` parameters from
    the plugin's properties) or a built-in `preset`, and the specular
    normalization Monte-Carlo'd at load time (irawan.cpp configure); the
    builder packs the pattern into the iw_* tables."""

    def _build(self, props):
        from mitsuba_tpu_torch.bsdf import irawan_host as iw

        if "filename" in props:
            with open(props.resolve_path(props.get_string("filename"))) as f:
                text = f.read()
        else:
            preset = props.get_string("preset", "plain")
            if preset not in iw.PRESETS:
                raise ValueError(
                    f"irawan: unknown preset {preset!r} (have {list(iw.PRESETS)}); pass "
                    "filename= for a weave pattern file")
            text = iw.PRESETS[preset]
        pattern = iw.parse_weave(text, props)
        rec = BSDFRecord(type=IRAWAN, weave=pattern)
        rec.repeat_u = props.get_float("repeatU", 1.0)
        rec.repeat_v = props.get_float("repeatV", 1.0)
        rec.iw_norm = iw.compute_normalization(pattern, rec.repeat_u, rec.repeat_v)
        if "ksMultiplier" in props or "kdMultiplier" in props:
            raise ValueError(
                "irawan: ksMultiplier/kdMultiplier were replaced by the normalization scheme; "
                "set yarn kd/ks instead (irawan.cpp:115-118)")
        # the yarns' mean diffuse colour, for users of a flat approximation
        rec.cA = np.mean([np.asarray(y.kd, np.float32) for y in pattern.yarns], axis=0)
        return rec
