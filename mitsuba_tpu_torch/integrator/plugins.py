"""Integrator plugins (port of mitsuba_tpu/integrator/plugins.py): `path`,
`volpath` and `volpath_simple` (both of kind "volpath"), `direct`, `ao`,
`field` and `depth` (a `field` of distances), `motion`, `bdpt`, `ptracer`, the
Metropolis family `pssmlt`, `mlt` and `erpt`, the photon-density and
many-light family `photonmapper`, `ppm`, `sppm` and `vpl`, and the
meta-integrators `adaptive`, `irrcache` and `multichannel` over nested
integrators, which read the reference's property names."""

from __future__ import annotations

from dataclasses import dataclass

from mitsuba_tpu_torch.scene.registry import register


@dataclass
class IntegratorRecord:
    kind: str = "path"
    max_depth: int = -1
    rr_depth: int = 5
    strict_normals: bool = False
    hide_emitters: bool = False
    # ao
    ray_length: float = -1.0
    # field
    field_name: str = "position"
    # motion: the target time and the chain configuration
    motion_time: float = 1.0
    motion_config: str = "d"
    # pssmlt / mlt / erpt
    direct_samples: int = -1
    bidirectional: bool = False
    luminance_samples: int = 100000
    p_large: float = 0.3
    chain_length: int = 100
    manifold_perturbation: bool = False
    # adaptive, irrcache, multichannel: the nested integrators
    sub_integrator: "IntegratorRecord | None" = None
    sub_integrators: "list | None" = None  # multichannel's children
    # adaptive
    max_error: float = 0.05
    max_sample_factor: float = 8.0


class _IntBase:
    kind = "path"

    def __init__(self, props):
        self.props = props
        self.record = IntegratorRecord(
            kind=self.kind,
            max_depth=props.get_int("maxDepth", -1),
            rr_depth=props.get_int("rrDepth", 5),
            strict_normals=props.get_bool("strictNormals", False),
            hide_emitters=props.get_bool("hideEmitters", False),
        )
        self._finish(props)

    def _finish(self, props):
        pass


def _refuse(props, name, default, get):
    """A property that no port code reads: refused, by name, unless it
    holds its default, so that no scene renders as if it were unset."""
    if get(name, default) != default:
        raise NotImplementedError(f"integrator property {name} = {get(name, default)} "
                                  f"is not ported (only {default})")


@register("integrator", "path")
class PathIntegrator(_IntBase):
    """reference: src/integrators/path/path.cpp:110 (MIPathTracer)."""

    kind = "path"


@register("integrator", "volpath")
class VolPathIntegrator(_IntBase):
    """reference: src/integrators/path/volpath.cpp:76."""

    kind = "volpath"


@register("integrator", "volpath_simple")
class VolPathSimpleIntegrator(_IntBase):
    kind = "volpath"


@register("integrator", "direct")
class DirectIntegrator(_IntBase):
    """reference: src/integrators/direct/direct.cpp (MIDirect)."""

    kind = "direct"

    def _finish(self, props):
        # one emitter and one BSDF sample per lane (as the reference's
        # direct_trace, which reads no sample counts)
        for name in ("shadingSamples", "emitterSamples", "bsdfSamples"):
            _refuse(props, name, 1, props.get_int)


@register("integrator", "ao")
class AOIntegrator(_IntBase):
    """reference: src/integrators/direct/ao.cpp (path.py ao_trace)."""

    kind = "ao"

    def _finish(self, props):
        self.record.ray_length = props.get_float("rayLength", -1.0)
        # one occlusion ray a lane (as the reference's ao_trace, which
        # reads no sample count)
        _refuse(props, "shadingSamples", 1, props.get_int)


@register("integrator", "field")
class FieldIntegrator(_IntBase):
    """reference: src/integrators/misc/field.cpp (path.py field_trace)."""

    kind = "field"

    def _finish(self, props):
        self.record.field_name = props.get_string("field", "position")


@register("integrator", "depth")
class DepthIntegrator(_IntBase):
    """The `distance` field (reference plugins.py:121-126)."""

    kind = "field"

    def _finish(self, props):
        self.record.field_name = "distance"


@register("integrator", "motion")
class MotionIntegrator(_IntBase):
    """reference: src/integrators/misc/motion.cpp: screen-space motion
    vectors to the target `time`.  config "d" is the first hit; a chain
    config of [rt]*d form ("rd", "ttd", ...) follows reflections and
    refractions and re-solves the chain at the target time with the
    manifold walk (integrator/path.py motion_trace)."""

    kind = "motion"

    def _finish(self, props):
        self.record.motion_time = props.get_float("time", 1.0)
        cfg = props.get_string("config", "d").lower()
        if not cfg or cfg[-1] != "d" or any(ch not in "rtd" for ch in cfg):
            raise ValueError("motion: config must be of [rt]*d form, got %r" % cfg)
        self.record.motion_config = cfg


@register("integrator", "bdpt")
class BDPTIntegrator(_IntBase):
    """reference: src/integrators/bdpt/bdpt.cpp:133."""

    kind = "bdpt"


@register("integrator", "pssmlt")
class PSSMLTIntegrator(_IntBase):
    """reference: src/integrators/pssmlt/pssmlt.cpp:150 (integrator/pssmlt.py).
    The mutations per pixel are not a property: render's spp sets them."""

    kind = "pssmlt"

    def _finish(self, props):
        self.record.bidirectional = props.get_bool("bidirectional", True)
        self.record.luminance_samples = props.get_int("luminanceSamples", 100000)
        _refuse(props, "twoStage", False, props.get_bool)
        self.record.p_large = props.get_float("pLarge", 0.3)
        # >= 0: render the direct component with this many ordinary samples
        # and keep the chains for longer paths (reference directSamples; -1
        # keeps everything in the chain target)
        self.record.direct_samples = props.get_int("directSamples", -1)


@register("integrator", "mlt")
class MLTIntegrator(PSSMLTIntegrator):
    """reference: src/integrators/mlt/mlt.cpp — the Veach mutation suite
    over chain tensors (integrator/mlt.py)."""

    kind = "mlt"

    def _finish(self, props):
        super()._finish(props)
        # reference mlt.cpp:194 — the manifold perturbation, opt-in
        self.record.manifold_perturbation = props.get_bool("manifoldPerturbation", False)


@register("integrator", "erpt")
class ERPTIntegrator(PSSMLTIntegrator):
    """reference: src/integrators/erpt/erpt.cpp:134 — energy redistribution
    with perturbation-only chains (integrator/mlt.py)."""

    kind = "erpt"

    def _finish(self, props):
        super()._finish(props)
        self.record.chain_length = props.get_int("chainLength", 100)


@register("integrator", "ptracer")
class PTracerIntegrator(_IntBase):
    """reference: src/integrators/ptracer/ptracer.cpp."""

    kind = "ptracer"


@register("integrator", "photonmapper")
class PhotonMapper(_IntBase):
    """reference: src/integrators/photonmapper/photonmapper.cpp (with a
    volume map and the beam radiance estimate, integrator/photonmapper.py)."""

    kind = "photonmapper"


@register("integrator", "ppm")
class PPMIntegrator(_IntBase):
    """reference: src/integrators/photonmapper/ppm.cpp; the sppm code
    renders it (integrator/sppm.py)."""

    kind = "ppm"


@register("integrator", "sppm")
class SPPMIntegrator(_IntBase):
    """reference: src/integrators/photonmapper/sppm.cpp (integrator/sppm.py)."""

    kind = "sppm"


@register("integrator", "vpl")
class VPLIntegrator(_IntBase):
    """reference: src/integrators/vpl/vpl.cpp (integrator/vpl.py)."""

    kind = "vpl"

    def _finish(self, props):
        # the geometry term is clamped at (0.1 * scene radius)^2: the
        # reference's vpl pass reads no clamping property
        _refuse(props, "clamping", 0.1, props.get_float)


class _MetaIntegrator(_IntBase):
    """The nested integrators: sub_integrator is the first,
    sub_integrators all of them (reference plugins.py:240-249)."""

    def _finish(self, props):
        subs = [child.record for _, child in props.children
                if isinstance(getattr(child, "record", None), IntegratorRecord)]
        if subs:
            self.record.sub_integrator = subs[0]
        self.record.sub_integrators = subs


@register("integrator", "adaptive")
class AdaptiveIntegrator(_MetaIntegrator):
    """reference: src/integrators/misc/adaptive.cpp — error-driven
    refinement over the nested integrator (integrator/adaptive.py)."""

    kind = "adaptive"

    def _finish(self, props):
        super()._finish(props)
        self.record.max_error = props.get_float("maxError", 0.05)
        self.record.max_sample_factor = props.get_float("maxSampleFactor", 8.0)


@register("integrator", "irrcache")
class IrrCacheIntegrator(_MetaIntegrator):
    """reference: src/integrators/misc/irrcache.cpp (integrator/irrcache.py)."""

    kind = "irrcache"


@register("integrator", "multichannel")
class MultiChannelIntegrator(_MetaIntegrator):
    """reference: src/integrators/misc/multichannel.cpp: each nested
    integrator renders with the same pack and seed, and the images stack
    as [H, W, 3 n] (renderer.py render)."""

    kind = "multichannel"
