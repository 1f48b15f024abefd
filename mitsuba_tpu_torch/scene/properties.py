"""Typed key->value parameter maps handed to every plugin constructor
(port of mitsuba_tpu/scene/properties.py)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from mitsuba_tpu_torch.core.transform import Transform


class PropertiesError(RuntimeError):
    pass


@dataclass
class Properties:
    plugin_name: str = ""
    id: str = ""
    _values: dict[str, Any] = field(default_factory=dict)
    # nested child plugins in document order: list of (name, plugin)
    children: list = field(default_factory=list)
    # directories searched for relative file names (the scene file's first)
    search_paths: list = field(default_factory=list)

    def resolve_path(self, filename: str) -> str:
        """Absolute names as given; relative ones against search_paths,
        then the working directory."""
        if os.path.isabs(filename) and os.path.exists(filename):
            return filename
        for base in self.search_paths + ["."]:
            cand = os.path.join(base, filename)
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(
            f"{self.plugin_name}: cannot resolve '{filename}' "
            f"(searched {self.search_paths})"
        )

    def __contains__(self, name):
        return name in self._values

    def set(self, name, value):
        self._values[name] = value

    def raw(self, name):
        return self._values[name]

    def _get(self, name, default, expected, caster):
        if name not in self._values:
            return default
        try:
            return caster(self._values[name])
        except (TypeError, ValueError) as e:
            raise PropertiesError(
                f"{self.plugin_name}: property '{name}' has incompatible "
                f"type (expected {expected}): {e}"
            ) from e

    def get_bool(self, name, default=None):
        def cast(v):
            if isinstance(v, bool):
                return v
            if isinstance(v, str):
                if v.lower() in ("true", "1"):
                    return True
                if v.lower() in ("false", "0"):
                    return False
            raise TypeError(v)

        return self._get(name, default, "bool", cast)

    def get_int(self, name, default=None):
        return self._get(name, default, "int", int)

    def get_float(self, name, default=None):
        return self._get(name, default, "float", float)

    def get_string(self, name, default=None):
        return self._get(name, default, "string", str)

    def get_point(self, name, default=None):
        """np [3] float64; a scalar broadcasts."""

        def cast(v):
            a = np.asarray(v, np.float64).ravel()
            if a.size == 1:
                a = np.full(3, a[0])
            if a.size != 3:
                raise TypeError(f"expected 3 components, got {a.size}")
            return a

        return self._get(name, default, "point", cast)

    def get_spectrum(self, name, default=None):
        """Linear-RGB np [3] float32; scalars broadcast to gray."""

        def cast(v):
            a = np.asarray(v, np.float64).ravel()
            if a.size == 1:
                a = np.full(3, a[0])
            if a.size != 3:
                raise TypeError(f"expected 1 or 3 components, got {a.size}")
            return a.astype(np.float32)

        if default is not None and not isinstance(default, np.ndarray):
            default = np.full(3, float(default), np.float32)
        return self._get(name, default, "spectrum", cast)

    def get_transform(self, name, default=None):
        def cast(v):
            if isinstance(v, Transform):
                return v
            return Transform(np.asarray(v))

        if default is None:
            default = Transform.identity()
        return self._get(name, default, "transform", cast)
