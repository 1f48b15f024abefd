"""Participating media, phase functions and volume data sources (port of
mitsuba_tpu/medium/plugins.py): the media `homogeneous` and
`heterogeneous` (reference src/medium/{homogeneous,heterogeneous}.cpp),
the phases `isotropic`, `hg`, `rayleigh`, `mixturephase` and the fiber
phases `kkay` and `microflake`, which read the heterogeneous medium's
`orientation` volume (src/phase/*), the volumes `constvolume`,
`gridvolume`, `hgridvolume` (flattened to one dense grid) and `volcache`
(its nested volume) (src/volume/*), and the `.vol` grid reader.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.scene.registry import register

# phase kinds, as numbered in the reference
ISOTROPIC = 0
HG = 1
RAYLEIGH = 2
KKAY = 3
MICROFLAKE = 4
FLAKE_LUT = 33  # entries of microflake's sigma_t(|cos theta|) table

HOMOGENEOUS = 0
HETEROGENEOUS = 1

# leaf components a mixture may carry (static table width)
MAX_PHASE_COMPONENTS = 4


@dataclass
class PhaseRecord:
    kind: int = ISOTROPIC
    g: float = 0.0
    # N-ary mixture (reference src/phase/mixturephase.cpp): list of
    # (kind, g, weight) leaves, weights normalized to 1; None = the
    # single component (kind, g).  Nested mixturephases flatten here.
    components: list | None = None
    # kajiya-kay (reference src/phase/kkay.cpp)
    ks: float = 0.4
    kd: float = 0.2
    exponent: float = 4.0
    knorm: float = 0.0
    # microflake's gaussian fiber distribution (reference
    # src/phase/microflake.cpp, microflake_fiber.h)
    stddev: float = 0.1
    flake_norm: float = 0.0
    flake_sigt: np.ndarray | None = None  # [FLAKE_LUT] sigma_t(|cos|)


def _kkay_normalization(exponent):
    """1 / (2 pi x the Simpson quadrature, 1,000 intervals, of the specular
    cone's integral) (reference kkay.cpp configure, plugins.py:54-62)."""
    n = 1000
    theta = (np.arange(1, n) * np.pi) / n
    vals = np.cos(theta - np.pi / 2) ** exponent * np.sin(theta)
    w = np.where(np.arange(1, n) % 2 == 1, 4.0, 2.0)
    integral = (vals * w).sum() * (np.pi / n) / 3.0
    return float(1.0 / (integral * 2.0 * np.pi))


def _flake_tables(stddev):
    """The gaussian fiber distribution D(m) ~ exp(-cos^2 / (2 s^2)) on the
    sphere: its normalization, and sigma_t(w) = int D(m) |w . m| dm at
    FLAKE_LUT values of |cos theta_w| in [0, 1] by quadrature (reference
    plugins.py:65-92, in place of microflake_fiber.h's fitted
    coefficients)."""
    from scipy.special import erf

    s = float(stddev)
    norm = 1.0 / ((2.0 * np.pi) ** 1.5 * s * erf(1.0 / (np.sqrt(2.0) * s)))
    nt, nph = 512, 256
    ct_m = np.linspace(-1.0, 1.0, nt)  # cos(theta_m)
    ph = (np.arange(nph) + 0.5) / nph * 2.0 * np.pi
    st_m = np.sqrt(np.maximum(1.0 - ct_m**2, 0.0))
    d = norm * np.exp(-(ct_m**2) / (2.0 * s * s))  # [nt]
    out = np.empty(FLAKE_LUT, np.float32)
    for i, ct_w in enumerate(np.linspace(0.0, 1.0, FLAKE_LUT)):
        st_w = np.sqrt(max(1.0 - ct_w * ct_w, 0.0))
        # |w . m| over the azimuth ring
        dots = np.abs(ct_w * ct_m[:, None] + st_w * st_m[:, None] * np.cos(ph)[None, :])
        ring = dots.mean(axis=1) * 2.0 * np.pi  # [nt]
        out[i] = np.trapezoid(d * ring, ct_m)
    return norm, out


class _PhaseBase:
    kind = ISOTROPIC

    def __init__(self, props):
        self.record = PhaseRecord(kind=self.kind)
        self._finish(props)

    def _finish(self, props):
        pass


@register("phase", "isotropic")
class IsotropicPhase(_PhaseBase):
    kind = ISOTROPIC


@register("phase", "hg")
class HGPhase(_PhaseBase):
    kind = HG

    def _finish(self, props):
        self.record.g = props.get_float("g", 0.8)


@register("phase", "rayleigh")
class RayleighPhase(_PhaseBase):
    kind = RAYLEIGH


@register("phase", "kkay")
class KajiyaKayPhase(_PhaseBase):
    """reference src/phase/kkay.cpp: the Kajiya-Kay fiber phase about the
    medium's local orientation, a diffuse part and a specular cone."""

    kind = KKAY

    def _finish(self, props):
        rec = self.record
        rec.ks = props.get_float("ks", 0.4)
        rec.kd = props.get_float("kd", 0.2)
        rec.exponent = props.get_float("exponent", 4.0)
        if rec.ks + rec.kd > 1.0:
            raise ValueError("kkay: ks + kd must be <= 1")
        rec.knorm = _kkay_normalization(rec.exponent)


@register("phase", "microflake")
class MicroflakePhase(_PhaseBase):
    """reference src/phase/microflake.cpp: specular microflakes of the
    gaussian fiber distribution (microflake_fiber.h) about the medium's
    orientation.  As in the reference port, sigma_t(w) does not modulate
    the medium's transmittance."""

    kind = MICROFLAKE

    def _finish(self, props):
        rec = self.record
        rec.stddev = props.get_float("stddev", 0.1)
        if not 0.01 <= rec.stddev <= 1.0:
            raise ValueError("microflake: stddev must be in [0.01, 1]")
        rec.flake_norm, rec.flake_sigt = _flake_tables(rec.stddev)


@register("phase", "mixturephase")
class MixturePhase(_PhaseBase):
    """N-ary weighted blend of nested phases (reference
    src/phase/mixturephase.cpp).  Nested mixturephases flatten into one
    leaf list (weight products), up to MAX_PHASE_COMPONENTS leaves,
    normalized and sorted by descending weight."""

    def _finish(self, props):
        kids = [child.record for _, child in props.children
                if isinstance(getattr(child, "record", None), PhaseRecord)]
        w = [float(x) for x in props.get_string("weights", "").split()]
        if not kids:
            return
        if len(w) != len(kids):
            w = [1.0 / len(kids)] * len(kids)
        if sum(w) > 1.0 + 1e-4:
            raise ValueError("mixturephase: weights sum to more than one")
        leaves = []  # flattened (kind, g, weight)
        for rec, weight in zip(kids, w):
            if rec.components is not None:
                leaves += [(k_, g_, w_ * weight) for k_, g_, w_ in rec.components]
            elif rec.kind in (KKAY, MICROFLAKE):
                raise ValueError("mixturephase: fiber phases (kkay/microflake) cannot be "
                                 "nested in a mixture")
            else:
                leaves.append((rec.kind, rec.g, weight))
        if len(leaves) > MAX_PHASE_COMPONENTS:
            raise ValueError(
                f"mixturephase: more than {MAX_PHASE_COMPONENTS} leaf components after flattening"
            )
        tot = sum(x[2] for x in leaves)
        leaves = [(k_, g_, w_ / max(tot, 1e-8)) for k_, g_, w_ in leaves]
        leaves.sort(key=lambda x: -x[2])
        self.record.components = leaves
        self.record.kind = leaves[0][0]
        self.record.g = leaves[0][1]


@dataclass
class VolumeRecord:
    """Volume data source (reference include/mitsuba/render/volume.h)."""

    constant: np.ndarray | None = None  # [3]
    grid: np.ndarray | None = None  # [D, H, W, C]
    aabb_min: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    aabb_max: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    to_world: Transform = field(default_factory=Transform.identity)


def load_vol(path) -> VolumeRecord:
    """Mitsuba `.vol` grid: magic 'VOL', version 3, encoding (1 = float32),
    resolution, channels, AABB, raw voxels
    (reference src/volume/gridvolume.cpp:56-102, 224-231)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:3] != b"VOL":
        raise ValueError(f"{path}: not a .vol file")
    if blob[3] != 3:
        raise ValueError(f"{path}: unsupported .vol version {blob[3]}")
    enc, xres, yres, zres, channels = struct.unpack_from("<iiiii", blob, 4)
    bbox = struct.unpack_from("<6f", blob, 24)
    if enc != 1:
        raise NotImplementedError(f"{path}: .vol encoding {enc} not yet ported")
    data = np.frombuffer(
        blob, "<f4", count=xres * yres * zres * channels, offset=48
    ).reshape(zres, yres, xres, channels)
    return VolumeRecord(
        grid=np.ascontiguousarray(data, np.float32),
        aabb_min=np.array(bbox[:3], np.float32),
        aabb_max=np.array(bbox[3:], np.float32),
    )


@register("volume", "constvolume")
class ConstVolume:
    def __init__(self, props):
        val = np.ones(3, np.float32)
        if "value" in props:
            raw = props.raw("value")
            val = (np.full(3, float(raw), np.float32) if isinstance(raw, (int, float, str))
                   else props.get_spectrum("value"))
        self.record = VolumeRecord(constant=np.asarray(val, np.float32))


@register("volume", "gridvolume")
class GridVolume:
    def __init__(self, props):
        self.record = load_vol(props.resolve_path(props.get_string("filename")))
        self.record.to_world = props.get_transform("toWorld")


@register("volume", "hgridvolume")
class HGridVolume:
    """A hierarchical grid (reference src/volume/hgridvolume.cpp:70-112,
    plugins.py:290-348): a dictionary file of the AABB (6 float32), the
    block-grid resolution (3 int32) and the occupied blocks' coordinates
    (3 int32 each), whose voxels live in the .vol files
    `{prefix}{x:03d}_{y:03d}_{z:03d}{postfix}` beside it.  The blocks are
    flattened into one dense grid (missing blocks are 0); the supergrid
    majorants of medium/eval.py keep the sparsity's gain."""

    def __init__(self, props):
        prefix = props.get_string("prefix")
        postfix = props.get_string("postfix")
        path = props.resolve_path(props.get_string("filename"))
        base = os.path.dirname(path)
        with open(path, "rb") as f:
            blob = f.read()
        lo_hi = struct.unpack_from("<6f", blob, 0)
        rx, ry, rz = struct.unpack_from("<3i", blob, 24)
        blocks = [struct.unpack_from("<3i", blob, off) for off in range(36, len(blob) - 11, 12)]
        if not blocks:
            raise ValueError(f"{path}: empty hgridvolume dictionary")
        grid = bres = None
        for bx, by, bz in blocks:
            sub = load_vol(os.path.join(base, f"{prefix}{bx:03d}_{by:03d}_{bz:03d}{postfix}"))
            g = sub.grid[..., 0]
            if grid is None:
                bres = g.shape  # (D, H, W) of every block
                grid = np.zeros((rz * bres[0], ry * bres[1], rx * bres[2]), np.float32)
            if g.shape != bres:
                raise NotImplementedError("hgridvolume: blocks with differing resolutions")
            grid[bz * bres[0]:(bz + 1) * bres[0], by * bres[1]:(by + 1) * bres[1],
                 bx * bres[2]:(bx + 1) * bres[2]] = g
        self.record = VolumeRecord(grid=grid, aabb_min=np.array(lo_hi[:3], np.float32),
                                   aabb_max=np.array(lo_hi[3:], np.float32),
                                   to_world=props.get_transform("toWorld"))


@register("volume", "volcache")
class VolCache:
    """A cache in front of a nested volume (reference src/volume/
    volcache.cpp): the nested volume's record, whose grid is on the device
    whole."""

    def __init__(self, props):
        for _, child in props.children:
            if getattr(child, "record", None) is not None:
                self.record = child.record
                return
        raise ValueError("volcache: requires a nested volume")


@dataclass
class MediumRecord:
    kind: int = HOMOGENEOUS
    sigma_s: np.ndarray = field(default_factory=lambda: np.full(3, 1.0, np.float32))
    sigma_a: np.ndarray = field(default_factory=lambda: np.full(3, 0.0, np.float32))
    phase: PhaseRecord = field(default_factory=PhaseRecord)
    scale: float = 1.0
    density: VolumeRecord | None = None  # heterogeneous
    albedo: VolumeRecord | None = None
    orientation: VolumeRecord | None = None  # the fiber phases' axes
    # transmittance: "woodcock" (ratio tracking) or "simpson"
    # (deterministic composite quadrature), reference heterogeneous.cpp
    # EIntegrationMethod
    method: str = "woodcock"
    # homogeneous free-path sampling strategy (reference
    # homogeneous.cpp:149-153): balance / single / manual / maximum
    strategy: str = "balance"
    sampling_density: float = 0.0  # single/manual exponential rate
    sampling_weight: float = -1.0  # mediumSamplingWeight override
    id: str = ""


class _MediumBase:
    kind = HOMOGENEOUS

    def __init__(self, props):
        self.record = MediumRecord(kind=self.kind, id=props.id)
        for _, child in props.children:
            if isinstance(getattr(child, "record", None), PhaseRecord):
                self.record.phase = child.record
        self._finish(props)


@register("medium", "homogeneous")
class HomogeneousMedium(_MediumBase):
    """reference: src/medium/homogeneous.cpp (closed-form transmittance)."""

    kind = HOMOGENEOUS

    def _finish(self, props):
        rec = self.record
        scale = props.get_float("scale", 1.0)
        if "sigmaT" in props and "albedo" in props:
            st = props.get_spectrum("sigmaT")
            al = props.get_spectrum("albedo")
            rec.sigma_s = (st * al * scale).astype(np.float32)
            rec.sigma_a = (st * (1 - al) * scale).astype(np.float32)
        else:
            rec.sigma_s = (props.get_spectrum("sigmaS", np.full(3, 1.0)) * scale).astype(np.float32)
            rec.sigma_a = (props.get_spectrum("sigmaA", np.full(3, 1.0)) * scale).astype(np.float32)

        strategy = props.get_string("strategy", "balance")
        if strategy not in ("balance", "single", "manual", "maximum"):
            raise ValueError(f"homogeneous: unknown sampling strategy '{strategy}'")
        rec.strategy = strategy
        rec.sampling_weight = props.get_float("mediumSamplingWeight", -1.0)
        sigma_t = rec.sigma_s + rec.sigma_a
        if strategy == "single":
            # default channel: the lowest-variance (smallest sigma_t)
            channel = props.get_int("channel", int(np.argmin(sigma_t)))
            if not 0 <= channel < 3:
                raise ValueError("homogeneous: channel out of range")
            rec.sampling_density = float(sigma_t[channel])
            if props.get_bool("monochromatic", False):
                rec.sigma_s = np.full(3, rec.sigma_s[channel], np.float32)
                rec.sigma_a = np.full(3, rec.sigma_a[channel], np.float32)
        elif strategy == "manual":
            rec.sampling_density = props.get_float("samplingDensity")
        elif strategy == "maximum" and len(set(np.round(sigma_t, 7).tolist())) < 3:
            # the maximum of exponentials needs distinct per-channel rates
            # (maxexp.h:38); for (partially) gray media it degenerates to
            # one exponential at the largest rate
            rec.strategy = "manual"
            rec.sampling_density = float(sigma_t.max())


@register("medium", "heterogeneous")
class HeterogeneousMedium(_MediumBase):
    """reference: src/medium/heterogeneous.cpp (Woodcock tracking :172)."""

    kind = HETEROGENEOUS

    def _finish(self, props):
        rec = self.record
        rec.scale = props.get_float("scale", 1.0)
        rec.method = props.get_string("method", "woodcock")
        if rec.method not in ("woodcock", "simpson"):
            raise ValueError(f"heterogeneous: unknown method '{rec.method}'")
        for name, child in props.children:
            if isinstance(getattr(child, "record", None), VolumeRecord):
                if name == "density":
                    rec.density = child.record
                elif name == "albedo":
                    rec.albedo = child.record
                elif name == "orientation":
                    rec.orientation = child.record
                elif rec.density is None:
                    rec.density = child.record
        if rec.density is None:
            raise ValueError("heterogeneous: requires a density volume")
        if rec.albedo is None:
            rec.albedo = VolumeRecord(constant=np.full(3, 0.9, np.float32))
