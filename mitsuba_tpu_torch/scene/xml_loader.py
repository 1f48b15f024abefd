"""Mitsuba XML scene loader (port of mitsuba_tpu/scene/xml_loader.py).

Builds nested `Properties`, instantiates plugins through the registry,
and supports `$param` substitution, `<default>`, `<ref>`, `<include>`,
`<alias>`, transform chains and `<animation>` keyframe tracks.  Shape
groups and their instances are collected into `SceneDescription.
shape_groups` and `.instances`; the builder expands them or builds the
two-level accelerator.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.core.spectrum import (
    blackbody_rgb,
    interpolated_spectrum_to_rgb,
    srgb_degamma,
)
from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.scene import registry
from mitsuba_tpu_torch.scene.properties import Properties

_PLUGIN_TAGS = {
    "integrator",
    "sensor",
    "camera",  # legacy alias
    "sampler",
    "film",
    "rfilter",
    "bsdf",
    "shape",
    "emitter",
    "luminaire",  # legacy alias
    "texture",
    "medium",
    "phase",
    "volume",
    "subsurface",
}

_TAG_TO_CATEGORY = {
    "camera": "sensor",
    "luminaire": "emitter",
}


@dataclass
class SceneDescription:
    integrator: object = None
    sensor: object = None
    shapes: list = field(default_factory=list)
    emitters: list = field(default_factory=list)  # non-shape emitters
    media: dict = field(default_factory=dict)  # top-level media by id
    ids: dict = field(default_factory=dict)
    path: str = ""
    # instancing (reference shapegroup.h:34): (group key, Transform) per
    # instance, and each group's shapes by key; whether they expand or go
    # through the two-level accelerator is decided at pack time
    instances: list = field(default_factory=list)
    shape_groups: dict = field(default_factory=dict)


def _parse_float_list(s):
    return [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]


def _parse_rgb(value: str):
    value = value.strip()
    if value.startswith("#"):
        h = value[1:]
        return np.array(
            [int(h[i : i + 2], 16) / 255.0 for i in (0, 2, 4)], np.float32
        )
    vals = _parse_float_list(value)
    if len(vals) == 1:
        return np.full(3, vals[0], np.float32)
    return np.asarray(vals[:3], np.float32)


def _parse_spectrum(value: str, search_paths):
    """<spectrum> values: uniform, 'lambda:value, ...' pairs, or a .spd
    filename on the search paths (reference: doc/format.tex spectrum
    section)."""
    value = value.strip()
    if ":" in value and os.path.sep not in value:
        lam, val = [], []
        for p in (p for p in re.split(r"[,\s]+", value) if p):
            a, b = p.split(":")
            lam.append(float(a))
            val.append(float(b))
        return interpolated_spectrum_to_rgb(np.array(lam), np.array(val))
    try:
        vals = _parse_float_list(value)
        if len(vals) == 1:
            return np.full(3, vals[0], np.float32)
        return np.asarray(vals[:3], np.float32)
    except ValueError:
        pass
    for base in search_paths + ["."]:
        cand = os.path.join(base, value)
        if os.path.exists(cand):
            lam, val = [], []
            with open(cand) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split()
                    lam.append(float(parts[0]))
                    val.append(float(parts[1]))
            return interpolated_spectrum_to_rgb(np.array(lam), np.array(val))
    raise ValueError(f"cannot parse spectrum '{value}'")


def _xyz_attrs(el, default=0.0):
    return np.array(
        [
            float(el.get("x", default)),
            float(el.get("y", default)),
            float(el.get("z", default)),
        ],
        np.float64,
    )


def _parse_transform(el):
    """Sequential transform chain: each child applies AFTER the previous
    (cur = op * cur, reference scenehandler.cpp transform tags)."""
    cur = Transform.identity()
    for child in el:
        tag = child.tag
        if tag == "translate":
            op = Transform.translate(*_xyz_attrs(child, 0.0))
        elif tag == "scale":
            if child.get("value") is not None:
                vals = _parse_float_list(child.get("value"))
                if len(vals) == 1:
                    vals = vals * 3
                op = Transform.scale(*vals[:3])
            else:
                op = Transform.scale(*_xyz_attrs(child, 1.0))
        elif tag == "rotate":
            axis = _xyz_attrs(child, 0.0)
            op = Transform.rotate(axis, float(child.get("angle", 0.0)))
        elif tag in ("lookat", "lookAt"):
            origin = np.array(_parse_float_list(child.get("origin")))
            target = np.array(_parse_float_list(child.get("target")))
            up = np.array(_parse_float_list(child.get("up", "0, 1, 0")))
            op = Transform.look_at(origin, target, up)
        elif tag == "matrix":
            vals = _parse_float_list(child.get("value"))
            if len(vals) == 16:
                m = np.array(vals).reshape(4, 4)
            elif len(vals) == 9:
                m = np.eye(4)
                m[:3, :3] = np.array(vals).reshape(3, 3)
            else:
                raise ValueError("matrix must have 9 or 16 entries")
            op = Transform(m)
        else:
            raise ValueError(f"unknown transform child <{tag}>")
        cur = op * cur
    return cur


class SceneLoader:
    def __init__(self, search_paths=None, defaults=None):
        self.search_paths = list(search_paths or [])
        self.defaults = dict(defaults or {})
        self.ids = {}

    def _subst(self, s: str) -> str:
        if "$" not in s:
            return s

        def repl(m):
            key = m.group(1)
            if key not in self.defaults:
                raise KeyError(
                    f"scene parameter ${key} is not defined "
                    f"(pass it in `defaults` or add a <default>)"
                )
            return str(self.defaults[key])

        return re.sub(r"\$(\w+)", repl, s)

    def _attr(self, el, name, default=None):
        v = el.get(name, default)
        return self._subst(v) if isinstance(v, str) else v

    def load(self, path) -> SceneDescription:
        path = os.path.abspath(path)
        self.search_paths.insert(0, os.path.dirname(path))
        tree = ET.parse(path)
        return self._load_root(tree.getroot(), path)

    def load_string(self, text, base_dir=".") -> SceneDescription:
        self.search_paths.insert(0, base_dir)
        return self._load_root(ET.fromstring(text), "<string>")

    def _load_root(self, root, path) -> SceneDescription:
        if root.tag != "scene":
            raise ValueError(f"{path}: root element must be <scene>")
        scene = SceneDescription(path=path)
        scene.ids = self.ids
        for el in root:
            self._scene_child(scene, el)
        if scene.integrator is None:
            from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord

            scene.integrator = IntegratorRecord(kind="path")
        if scene.sensor is None:
            raise ValueError(f"{path}: scene has no sensor")
        return scene

    def _scene_child(self, scene, el):
        tag = el.tag
        if tag == "default":
            name = el.get("name")
            if name not in self.defaults:
                self.defaults[name] = self._attr(el, "value")
            return
        if tag == "include":
            fname = self._attr(el, "filename")
            for base in self.search_paths + ["."]:
                cand = os.path.join(base, fname)
                if os.path.exists(cand):
                    for child in ET.parse(cand).getroot():
                        self._scene_child(scene, child)
                    return
            raise FileNotFoundError(f"include: {fname}")
        if tag == "alias":
            self.ids[el.get("as")] = self.ids[el.get("id")]
            return
        if tag == "null":
            return
        if tag not in _PLUGIN_TAGS and tag != "ref":
            raise ValueError(f"unexpected top-level element <{tag}>")

        obj = self._plugin(el)
        cat = _TAG_TO_CATEGORY.get(tag, tag)
        if cat == "integrator":
            scene.integrator = obj.record
        elif cat == "sensor":
            self._finalize_sensor(obj)
            scene.sensor = obj
        elif cat == "shape":
            self._finalize_shape(scene, obj)
        elif cat == "emitter":
            scene.emitters.append(obj.record)
        elif cat == "medium":
            scene.media[obj.record.id or "default"] = obj.record
        # top-level bsdfs etc. exist only to define ids

    def _finalize_sensor(self, sensor_obj):
        from mitsuba_tpu_torch.film.plugins import FilmRecord
        from mitsuba_tpu_torch.sampler.plugins import SamplerRecord

        for _, child in sensor_obj.props.children:
            rec = getattr(child, "record", None)
            if isinstance(rec, FilmRecord):
                sensor_obj.record.film = rec
            elif isinstance(rec, SamplerRecord):
                sensor_obj.record.sampler = rec
        if sensor_obj.record.film is None:
            sensor_obj.record.film = FilmRecord()
        if sensor_obj.record.sampler is None:
            sensor_obj.record.sampler = SamplerRecord()
        sensor_obj.resolve_fov(
            sensor_obj.record.film.width, sensor_obj.record.film.height
        )

    def _finalize_shape(self, scene, shape_obj):
        """A top-level shape joins the scene.  A shape group is a container
        only (reference shapegroup.cpp): its shapes join the scene through
        the instances that reference it, attached once per group (reference
        xml_loader.py:293-322)."""
        from mitsuba_tpu_torch.scene.shapes import InstanceShape, ShapeGroup

        if isinstance(shape_obj, ShapeGroup):
            shape_obj.children = [child for _, child in shape_obj.props.children
                                  if hasattr(child, "instance")]
            return
        if isinstance(shape_obj, InstanceShape):
            group = None
            for _, child in shape_obj.props.children:
                if isinstance(child, ShapeGroup):
                    group = child
            if group is None:
                raise ValueError("instance: requires a shapegroup reference")
            key = id(group)
            if key not in scene.shape_groups:
                for child in group.children:
                    self._attach_shape_children(child)
                scene.shape_groups[key] = [child.instance for child in group.children]
            scene.instances.append((key, shape_obj.to_world))
            return
        self._attach_shape_children(shape_obj)
        scene.shapes.append(shape_obj.instance)
        self._attach_nested_sensor(scene, shape_obj)

    def _attach_nested_sensor(self, scene, shape_obj):
        """A sensor nested in a shape is attached to it: the
        irradiancemeter inherits its parent shape (reference
        src/sensors/irradiancemeter.cpp:80-83)."""
        from mitsuba_tpu_torch.sensor.plugins import SensorRecord

        for _, child in shape_obj.props.children:
            rec = getattr(child, "record", None)
            if isinstance(rec, SensorRecord):
                rec.parent_shape = shape_obj.instance
                self._finalize_sensor(child)
                scene.sensor = child

    def _attach_shape_children(self, shape_obj):
        from mitsuba_tpu_torch.bsdf.plugins import BSDFRecord
        from mitsuba_tpu_torch.emitter.plugins import EmitterRecord
        from mitsuba_tpu_torch.medium.plugins import MediumRecord
        from mitsuba_tpu_torch.scene.subsurface import SubsurfaceRecord

        inst = shape_obj.instance
        for name, child in shape_obj.props.children:
            rec = getattr(child, "record", None)
            if isinstance(rec, BSDFRecord):
                inst.bsdf = rec
            elif isinstance(rec, EmitterRecord):
                inst.emitter = rec
            elif isinstance(rec, SubsurfaceRecord):
                inst.subsurface = rec
            elif isinstance(rec, MediumRecord):
                # a nested or referenced medium: "interior" unless named
                # "exterior" (reference xml_loader.py _attach_shape_children)
                if name == "interior" or not name:
                    inst.interior_medium = rec
                elif name == "exterior":
                    inst.exterior_medium = rec
            # other children (a deformable's keyframe shapes, a nested
            # sensor: _attach_nested_sensor) attach nothing here

    def _plugin(self, el):
        tag = el.tag
        if tag == "ref":
            rid = self._attr(el, "id")
            if rid not in self.ids:
                raise KeyError(f"<ref id=\"{rid}\"> is undefined")
            return self.ids[rid]
        category = _TAG_TO_CATEGORY.get(tag, tag)
        type_name = self._attr(el, "type")
        props = Properties(
            plugin_name=f"{category}:{type_name}", id=el.get("id", ""),
            search_paths=self.search_paths,
        )
        self._fill_props(props, el)
        obj = registry.create(category, type_name, props)
        if el.get("id"):
            self.ids[el.get("id")] = obj
        return obj

    def _fill_props(self, props, el):
        for child in el:
            tag = child.tag
            name = self._attr(child, "name", "")
            if tag == "integer":
                props.set(name, int(float(self._attr(child, "value"))))
            elif tag == "float":
                props.set(name, float(self._attr(child, "value")))
            elif tag == "boolean":
                props.set(name, self._attr(child, "value").lower() == "true")
            elif tag == "string":
                props.set(name, self._attr(child, "value"))
            elif tag in ("point", "vector"):
                if child.get("value") is not None:
                    props.set(
                        name,
                        np.array(_parse_float_list(self._attr(child, "value"))),
                    )
                else:
                    props.set(name, _xyz_attrs(child))
            elif tag == "rgb":
                props.set(name, _parse_rgb(self._attr(child, "value")))
            elif tag == "srgb":
                props.set(name, srgb_degamma(_parse_rgb(self._attr(child, "value"))))
            elif tag == "spectrum":
                props.set(name, _parse_spectrum(self._attr(child, "value"), self.search_paths))
            elif tag == "blackbody":
                t = float(self._attr(child, "temperature"))
                props.set(name, blackbody_rgb(t) * float(child.get("scale", 1.0)))
            elif tag == "transform":
                props.set(name or "toWorld", _parse_transform(child))
            elif tag == "animation":
                # keyframes [(time, Transform), ...] sorted by time;
                # get_transform evaluates keyframe 0, get_animation
                # returns the track
                frames = [
                    (float(c.get("time", i)), _parse_transform(c))
                    for i, c in enumerate(child)
                    if c.tag == "transform"
                ]
                if frames:
                    frames.sort(key=lambda f: f[0])
                    props.set(name or "toWorld", frames)
            elif tag == "ref" or tag in _PLUGIN_TAGS:
                props.children.append((name, self._plugin(child)))
            elif tag == "default":
                dname = child.get("name")
                if dname not in self.defaults:
                    self.defaults[dname] = self._attr(child, "value")
            elif tag == "alias":
                self.ids[child.get("as")] = self.ids[child.get("id")]
            elif tag == "null":
                props.children.append((name, None))
            else:
                raise ValueError(f"unknown element <{tag}> in <{el.tag}>")


def load_scene(path, defaults=None, search_paths=None) -> SceneDescription:
    """Parse a Mitsuba scene XML file (the reference's loadScene)."""
    return SceneLoader(search_paths, defaults).load(path)


def load_scene_string(text, base_dir=".", defaults=None) -> SceneDescription:
    return SceneLoader(None, defaults).load_string(text, base_dir)
