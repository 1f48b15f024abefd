"""Integrator plugins (port of mitsuba_tpu/integrator/plugins.py): `path`,
and `volpath` and `volpath_simple` (both of kind "volpath")."""

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
