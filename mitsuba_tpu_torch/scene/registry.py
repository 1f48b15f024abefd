"""Plugin registry: name -> factory (port of
mitsuba_tpu/scene/registry.py).

Only the plugins of the ported slice are registered; asking for any
other plugin raises NotImplementedError naming it.
"""

from __future__ import annotations

from typing import Any, Callable

_REGISTRY: dict[str, dict[str, Callable]] = {}

CATEGORIES = (
    "integrator",
    "bsdf",
    "emitter",
    "sensor",
    "shape",
    "sampler",
    "film",
    "rfilter",
    "medium",
    "phase",
    "texture",
    "volume",
    "subsurface",
)


def register(category: str, name: str):
    """Class decorator: register a plugin factory."""
    if category not in CATEGORIES:
        raise ValueError(f"unknown plugin category '{category}'")

    def deco(cls):
        _REGISTRY.setdefault(category, {})[name] = cls
        cls.plugin_category = category
        cls.plugin_name = name
        return cls

    return deco


def create(category: str, name: str, props) -> Any:
    """Instantiate plugin `name` of `category` from Properties."""
    _ensure_loaded()
    if category not in CATEGORIES:
        raise ValueError(f"unknown plugin category '{category}'")
    cat = _REGISTRY.get(category, {})
    if name not in cat:
        raise NotImplementedError(f"{category} '{name}' not yet ported")
    return cat[name](props)


def names(category: str):
    _ensure_loaded()
    return sorted(_REGISTRY.get(category, {}))


def _ensure_loaded():
    """Import the plugin modules (they register themselves on import;
    a repeated import is a no-op)."""
    import mitsuba_tpu_torch.bsdf.plugins  # noqa: F401
    import mitsuba_tpu_torch.emitter.plugins  # noqa: F401
    import mitsuba_tpu_torch.film.plugins  # noqa: F401
    import mitsuba_tpu_torch.integrator.plugins  # noqa: F401
    import mitsuba_tpu_torch.sampler.plugins  # noqa: F401
    import mitsuba_tpu_torch.scene.shapes  # noqa: F401
    import mitsuba_tpu_torch.sensor.plugins  # noqa: F401
