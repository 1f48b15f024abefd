"""Integrator plugins (port of mitsuba_tpu/integrator/plugins.py): `path`,
`volpath` and `volpath_simple` (both of kind "volpath"), `bdpt` and
`ptracer`."""

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


@register("integrator", "bdpt")
class BDPTIntegrator(_IntBase):
    """reference: src/integrators/bdpt/bdpt.cpp:133."""

    kind = "bdpt"


@register("integrator", "ptracer")
class PTracerIntegrator(_IntBase):
    """reference: src/integrators/ptracer/ptracer.cpp."""

    kind = "ptracer"
