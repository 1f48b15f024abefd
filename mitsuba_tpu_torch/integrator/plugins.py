"""Integrator plugins (port of mitsuba_tpu/integrator/plugins.py): `path`."""

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


@register("integrator", "path")
class PathIntegrator:
    """reference: src/integrators/path/path.cpp:110 (MIPathTracer)."""

    def __init__(self, props):
        self.props = props
        self.record = IntegratorRecord(
            kind="path",
            max_depth=props.get_int("maxDepth", -1),
            rr_depth=props.get_int("rrDepth", 5),
            strict_normals=props.get_bool("strictNormals", False),
            hide_emitters=props.get_bool("hideEmitters", False),
        )
