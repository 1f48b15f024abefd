"""The reference's own reading of a configuration's scene XML.

A plain parser of the subset the configurations use: the path
integrator, a perspective sensor with a lookat transform, the gaussian
filter, diffuse BSDFs (by id or inline), rectangle and cube shapes with
scale / rotate / translate transforms, area emitters and a constant
environment.  It follows Mitsuba 0.5's documented semantics and shares no
code with the program: triangles come from the shapes' own definitions
(the rectangle and cube of src/shapes/rectangle.cpp and cube.cpp).
Anything outside the subset raises.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np


@dataclass
class RefScene:
    v0: np.ndarray  # [T, 3] float64 triangle corners
    v1: np.ndarray
    v2: np.ndarray
    albedo: np.ndarray  # [T, 3] diffuse reflectance
    radiance: np.ndarray  # [T, 3] area emission (zero where none)
    env: np.ndarray | None  # [3] constant environment radiance
    max_depth: int
    rr_depth: int
    origin: np.ndarray  # [3] camera position
    to_world: np.ndarray  # [3, 3] columns: left, up, forward
    tan_half_x: float
    width: int
    height: int
    filter_stddev: float
    filter_radius: float


def _floats(s):
    return [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]


def _rgb(el):
    vals = _floats(el.get("value"))
    return np.array(vals * 3 if len(vals) == 1 else vals, np.float64)


def _rotation(axis, angle_deg):
    """Rodrigues' rotation by `angle_deg` about `axis` (Transform::rotate)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = math.radians(angle_deg)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(th) * k + (1 - math.cos(th)) * (k @ k)


def _transform(el):
    """(3x3 linear part, translation) of a <transform>: each element
    applies after the ones before it."""
    m, t = np.eye(3), np.zeros(3)
    if el is None:
        return m, t
    for op in el:
        if op.tag == "scale":
            s = np.diag([float(op.get(k, "1")) for k in "xyz"])
            m, t = s @ m, s @ t
        elif op.tag == "rotate":
            r = _rotation([float(op.get(k, "0")) for k in "xyz"], float(op.get("angle")))
            m, t = r @ m, r @ t
        elif op.tag == "translate":
            t = t + np.array([float(op.get(k, "0")) for k in "xyz"])
        else:
            raise ValueError(f"transform element <{op.tag}> is outside the reference's subset")
    return m, t


def _lookat(el):
    origin = np.array(_floats(el.get("origin")))
    target = np.array(_floats(el.get("target")))
    up = np.array(_floats(el.get("up")))
    fwd = (target - origin) / np.linalg.norm(target - origin)
    left = np.cross(up, fwd)
    left /= np.linalg.norm(left)
    new_up = np.cross(fwd, left)
    return origin, np.stack([left, new_up, fwd], axis=1)


def rectangle():
    """[-1, 1]^2 in z = 0, normal +z (src/shapes/rectangle.cpp)."""
    p = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64)
    return p, np.array([[0, 1, 2], [2, 3, 0]])


def cube():
    """[-1, 1]^3, each face two triangles wound outward."""
    tris = []
    for axis in range(3):
        u, v = (axis + 1) % 3, (axis + 2) % 3
        for sign in (-1.0, 1.0):
            corners = []
            for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                c = np.zeros(3)
                c[axis], c[u], c[v] = sign, a, b
                corners.append(c)
            q = [0, 1, 2, 3] if sign > 0 else [0, 3, 2, 1]
            tris += [[corners[q[0]], corners[q[1]], corners[q[2]]],
                     [corners[q[0]], corners[q[2]], corners[q[3]]]]
    t = np.asarray(tris)
    return t.reshape(-1, 3), np.arange(len(t) * 3).reshape(-1, 3)


def _diffuse(el, ids):
    if el.tag == "ref":
        el = ids[el.get("id")]
    if el.get("type") != "diffuse":
        raise ValueError(f"bsdf {el.get('type')!r} is outside the reference's subset")
    refl = el.find("rgb[@name='reflectance']")
    return _rgb(refl) if refl is not None else np.full(3, 0.5)


def load(xml_text, width=None, height=None):
    """RefScene of `xml_text`; `width`/`height` replace the film's."""
    root = ET.fromstring(xml_text)
    ids = {el.get("id"): el for el in root.iter() if el.get("id") and el.tag != "ref"}
    integ = root.find("integrator")
    if integ.get("type") != "path":
        raise ValueError("the reference renders the path integrator only")
    ints = {e.get("name"): int(e.get("value")) for e in integ.findall("integer")}
    sensor = root.find("sensor")
    if sensor.get("type") != "perspective":
        raise ValueError("the reference has the perspective sensor only")
    fov = float(sensor.find("float[@name='fov']").get("value"))
    axis = sensor.find("string[@name='fovAxis']")
    if axis is not None and axis.get("value") != "x":
        raise ValueError("the reference takes the fov along x only")
    origin, to_world = _lookat(sensor.find("transform/lookat"))
    film = sensor.find("film")
    w = width or int(film.find("integer[@name='width']").get("value"))
    h = height or int(film.find("integer[@name='height']").get("value"))
    rf = film.find("rfilter")
    kind = rf.get("type") if rf is not None else "gaussian"
    if kind != "gaussian":
        raise ValueError("the reference has the gaussian filter only")
    sd = rf.find("float[@name='stddev']") if rf is not None else None
    stddev = float(sd.get("value")) if sd is not None else 0.5

    corners, albedo, radiance = [], [], []
    for shape in root.findall("shape"):
        kind = shape.get("type")
        if kind == "rectangle":
            p, idx = rectangle()
        elif kind == "cube":
            p, idx = cube()
        else:
            raise ValueError(f"shape {kind!r} is outside the reference's subset")
        m, t = _transform(shape.find("transform"))
        p = p @ m.T + t
        if np.linalg.det(m) < 0:
            idx = idx[:, [0, 2, 1]]
        tri = p[np.asarray(idx, np.int64)]
        bsdf = next((c for c in shape if c.tag in ("bsdf", "ref")), None)
        a = _diffuse(bsdf, ids) if bsdf is not None else np.full(3, 0.5)
        em = shape.find("emitter")
        if em is not None and em.get("type") != "area":
            raise ValueError("shapes carry area emitters only")
        le = _rgb(em.find("rgb[@name='radiance']")) if em is not None else np.zeros(3)
        corners.append(tri)
        albedo.append(np.broadcast_to(a, (len(tri), 3)))
        radiance.append(np.broadcast_to(le, (len(tri), 3)))
    env = None
    for em in root.findall("emitter"):
        if em.get("type") != "constant":
            raise ValueError(f"emitter {em.get('type')!r} is outside the reference's subset")
        val = em.find("*[@name='radiance']")
        env = _rgb(val) if val is not None else np.ones(3)
    tri = np.concatenate(corners)
    return RefScene(
        v0=tri[:, 0], v1=tri[:, 1], v2=tri[:, 2], albedo=np.concatenate(albedo),
        radiance=np.concatenate(radiance), env=env,
        max_depth=ints.get("maxDepth", -1), rr_depth=ints.get("rrDepth", 5),
        origin=origin, to_world=to_world, tan_half_x=math.tan(math.radians(fov) / 2),
        width=w, height=h, filter_stddev=stddev, filter_radius=4.0 * stddev)
