"""The plain reference on small cases."""

import os

import numpy as np
import pytest
import torch

from portbench.lib import cells, scenes
from portbench.reference import raycast
from portbench.reference import scene as ref_scene


def test_caster_against_brute_force():
    rng = np.random.default_rng(1)
    v0 = rng.uniform(-1, 1, (300, 3))
    v1 = v0 + rng.normal(scale=0.3, size=(300, 3))
    v2 = v0 + rng.normal(scale=0.3, size=(300, 3))
    o = rng.uniform(-2, 2, (500, 3))
    d = rng.normal(size=(500, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = raycast.Caster(v0, v1, v2, "cpu", torch.float64)
    t, prim = c.closest(torch.tensor(o), torch.tensor(d))
    # brute force, every ray against every triangle
    e1, e2 = v1 - v0, v2 - v0
    best = np.full(500, np.inf)
    for k in range(300):
        p = np.cross(d, e2[k])
        det = p @ e1[k]
        tv = o - v0[k]
        u = np.einsum("ij,ij->i", tv, p) / det
        q = np.cross(tv, e1[k])
        v = np.einsum("ij,ij->i", d, q) / det
        tt = (q @ e2[k]) / det
        ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 0)
        best = np.where(ok & (tt < best), tt, best)
    assert np.allclose(t.numpy(), best, rtol=1e-12, equal_nan=False)
    assert ((prim.numpy() >= 0) == np.isfinite(best)).all()


def test_cube_and_rectangle_face_out():
    for p, idx in (ref_scene.rectangle(), ref_scene.cube()):
        tri = p[idx]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        centre = tri.mean(axis=1)
        if len(idx) == 2:
            assert (n[:, 2] > 0).all()
        else:
            assert (np.einsum("ij,ij->i", n, centre) > 0).all() and len(idx) == 12


def test_cbox_reading():
    cfg = dict(cells.read_json(os.path.join(cells.HARNESS_DIR, "configs", "cbox.json")),
               dir=os.path.join(cells.HARNESS_DIR, "configs"))
    xml = scenes.scene_xml(cfg)
    ref = scenes.reference_scene(xml, 64, 48)
    assert len(ref.v0) == 36 and (ref.width, ref.height) == (64, 48)
    assert int((ref.radiance.max(axis=1) > 0).sum()) == 2  # the light's two triangles
    with pytest.raises(ValueError):
        scenes.reference_scene(xml.replace('type="cube"', 'type="ply"', 1), 64, 48)
