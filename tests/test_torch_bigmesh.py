"""The port's big-mesh slice as a whole, on the CPU: scenes/bunny.xml's
configuration (path tracer, maxDepth 5, constant environment, diffuse
mesh) on seeded meshes above 512 triangles, rendered by the reference and
by the port through load_scene -> pack_scene -> render; plus the constant
emitter's sampling and evaluation against the reference.

Tolerances: renders at tests/test_golden.py's gate (tone-mapped RMSE <
5e-3; both draw the same random numbers, so the difference is path
divergence from last-place arithmetic); the white furnace at the
reference's own furnace gate (|mean - 1| < 0.015, tests/test_render.py);
emitter samples at rtol 1e-5 (XLA's and PyTorch's sin/cos/sqrt may differ
in the last place)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu
import mitsuba_tpu_torch as mt
from mitsuba_tpu.emitter import eval as jem
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.emitter import eval as tem
from mitsuba_tpu_torch.scene.builder import pack_from_numpy, pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from torch_meshes import bunny_scene_xml, bunny_standin, uv_sphere, write_ply

torch.set_num_threads(1)


def _tonemapped_rmse(img, ref):
    return float(np.sqrt(np.mean((img / (1 + img) - ref / (1 + ref)) ** 2)))


@pytest.fixture(scope="module")
def mesh_xml(tmp_path_factory):
    """bunny.xml at 32x32 on a 4,992-triangle stand-in mesh."""
    path = str(tmp_path_factory.mktemp("mesh") / "standin.ply")
    write_ply(path, *bunny_standin(seed=3, n_phi=64, n_theta=40))
    return bunny_scene_xml(path, 32, 32)


def test_bigmesh_render_matches_reference(mesh_xml):
    ref = mitsuba_tpu.render(jload_string(mesh_xml), spp=4, seed=0)
    scene = load_scene_string(mesh_xml)
    img = mt.render(scene, spp=4, seed=0, device="cpu")
    assert img.shape == ref.shape == (32, 32, 3) and np.isfinite(img).all()
    assert 0.1 < img.mean() < 1.0 and (img < 0.99).mean() > 0.3  # the mesh is in view
    assert _tonemapped_rmse(img, np.asarray(ref)) < 5e-3


def test_reference_pack_renders_identically(mesh_xml):
    """A converted reference BVH pack renders bit for bit like the port's
    own pack of the same scene."""
    jp = jpack_scene(jload_string(mesh_xml))
    converted = pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")
    scene = load_scene_string(mesh_xml)
    a = mt.render(scene, spp=1, seed=2, device="cpu")
    b = mt.render(scene, spp=1, seed=2, device="cpu", pack=converted)
    np.testing.assert_array_equal(a, b)


FURNACE = """
<scene version="0.5.0">
  <integrator type="path"/>
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="toWorld"><lookat origin="0, 0, 4" target="0, 0, 0" up="0, 1, 0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="16"/></sampler>
    <film type="hdrfilm"><integer name="width" value="16"/><integer name="height" value="16"/></film>
  </sensor>
  <emitter type="constant"><spectrum name="radiance" value="1"/></emitter>
  <shape type="ply"><string name="filename" value="{ply}"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="1, 1, 1"/></bsdf></shape>
</scene>
"""


def test_white_furnace(tmp_path):
    """An albedo-1 closed convex mesh (528 triangles, so the BVH path) in
    a unit constant environment is indistinguishable from it."""
    path = str(tmp_path / "sphere.ply")
    write_ply(path, *uv_sphere(24, 12))
    scene = load_scene_string(FURNACE.format(ply=path))
    pack = pack_scene(scene, "cpu")
    assert pack.meta["use_bvh"] and pack.meta["n_clusters"] > 1
    img = mt.render(scene, seed=0, device="cpu", pack=pack)
    assert abs(float(img.mean()) - 1.0) < 0.015, float(img.mean())


MIXED = """
<scene version="0.5.0">
  <sensor type="perspective"/>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1" angle="90"/><translate y="3"/></transform>
    <emitter type="area"><rgb name="radiance" value="4"/><float name="samplingWeight" value="3"/></emitter></shape>
  <shape type="rectangle"><transform name="toWorld"><scale value="3"/><rotate x="1" angle="-90"/></transform></shape>
  <emitter type="constant"><rgb name="radiance" value="0.5, 1, 2"/></emitter>
</scene>
"""


def test_constant_emitter_matches_reference():
    """sample_direct over an area light and a constant environment (the
    lane's emitter picks its branch), eval_env and pdf_direct_env."""
    jp = jpack_scene(jload_string(MIXED))
    tp = pack_scene(load_scene_string(MIXED), "cpu")
    assert tp.meta["has_env"] and tp.meta["has_area"]
    assert tp.meta["env_idx"] == jp.meta["env_idx"] == 0
    rng = np.random.default_rng(4)
    n = 2000
    p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    u3 = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ref = jem.sample_direct(jp, jnp.asarray(p), jnp.asarray(u3))
    out = tem.sample_direct(tp, torch.as_tensor(p), torch.as_tensor(u3))
    kind = out.kind.numpy()
    np.testing.assert_array_equal(kind, np.asarray(ref.kind))
    assert 0.1 < (kind == 5).mean() < 0.5
    for name in ("d", "dist", "pdf", "value", "n"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-5, atol=1e-6, err_msg=name,
        )
    np.testing.assert_array_equal(out.delta.numpy(), np.asarray(ref.delta))
    d = out.d
    np.testing.assert_array_equal(tem.eval_env(tp, d).numpy(), np.asarray(jem.eval_env(jp, jnp.asarray(d.numpy()))))
    np.testing.assert_array_equal(
        tem.pdf_direct_env(tp, d).numpy(), np.asarray(jem.pdf_direct_env(jp, jnp.asarray(d.numpy())))
    )
