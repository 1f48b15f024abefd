"""Participating media, phase functions and volume data sources (port of
mitsuba_tpu/medium/plugins.py): the media `homogeneous` and
`heterogeneous` (reference src/medium/{homogeneous,heterogeneous}.cpp),
the phases `isotropic`, `hg`, `rayleigh` and `mixturephase`
(src/phase/*), the volumes `constvolume` and `gridvolume`
(src/volume/*) and the `.vol` grid reader.  The fiber phases (`kkay`,
`microflake`) and the volumes `hgridvolume` and `volcache` are not
registered, so the registry refuses them by name.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.scene.registry import register

# phase kinds, as numbered in the reference (KKAY = 3 and MICROFLAKE = 4
# are not ported: the pack refuses them)
ISOTROPIC = 0
HG = 1
RAYLEIGH = 2
KKAY = 3
MICROFLAKE = 4

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


@dataclass
class MediumRecord:
    kind: int = HOMOGENEOUS
    sigma_s: np.ndarray = field(default_factory=lambda: np.full(3, 1.0, np.float32))
    sigma_a: np.ndarray = field(default_factory=lambda: np.full(3, 0.0, np.float32))
    phase: PhaseRecord = field(default_factory=PhaseRecord)
    scale: float = 1.0
    density: VolumeRecord | None = None  # heterogeneous
    albedo: VolumeRecord | None = None
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
                    continue  # read only by the fiber phases, which are refused
                elif rec.density is None:
                    rec.density = child.record
        if rec.density is None:
            raise ValueError("heterogeneous: requires a density volume")
        if rec.albedo is None:
            rec.albedo = VolumeRecord(constant=np.full(3, 0.9, np.float32))
