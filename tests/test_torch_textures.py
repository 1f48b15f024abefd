"""The port's textures (mitsuba_tpu_torch/scene/textures.py, scene/builder.py's
texture tables and atlas, scene/texture_eval.py eval_texture and
mip_footprint, io/meshes.py's PLY colours) against the reference
(mitsuba_tpu/scene/textures.py, scene/builder.py, scene/texture_eval.py,
io/meshes.py), on inputs made from seeds with numpy, and the texture
slice's renders against the JAX package's goldens.

Tolerances (measured on these inputs):

* _mip_chain, _vertex_curvatures, the packs' texture tables, atlas,
  per-corner colours and curvatures (tex_*, tri_c*, tri_kh, tri_kg):
  equal, dtype included (the same float32 / float64 numpy code), but the
  atlas texels of an LDR image within one last place (rtol 2.4e-7): the
  sRGB curve's float32 pow is numpy's in the port and XLA's in the
  reference (as tests/test_torch_scene.py's srgb reflectance);
* eval_texture, every kind and every bitmap arm (level 0 bilinear and
  nearest, trilinear of a scalar footprint, the feline probes and the EWA
  of an ellipse): within atol 2e-6 and rtol 1e-5 (measured: at most 1e-6
  on most arms; log2 and exp differ between XLA and torch in the last
  place, which moves a level's weight or an EWA texel's weight by as
  much);
* mip_footprint: within rtol 1e-4 (atol 1e-7) on 99.9 % of the values
  and 1e-3 on all (measured: the 99.9 % quantile 2.4e-5; 4 values of
  8,192 at up to 3.4e-4, lanes of nearly parallel random partials, where
  E G - F^2 cancels);
* the geometry kinds on lanes whose prim is not a triangle (a sphere's
  id, an id past the tables): the reference's values, which index the
  triangle tables with the id clamped into them (ROADMAP C4);
* the goldens: tests/torch_meshes.py GOLDEN_GATES.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.io.meshes import load_ply as jload_ply
from mitsuba_tpu.scene import builder as jbuilder
from mitsuba_tpu.scene import texture_eval as jtex
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.io.meshes import load_ply
from mitsuba_tpu_torch.scene import builder as tbuilder
from mitsuba_tpu_torch.scene import texture_eval as ttex
from mitsuba_tpu_torch.scene.builder import GEOM_TEX_ARRAYS, SLICE_ARRAYS, SLICE_META, pack_scene
from tests.torch_meshes import (
    GOLDEN_GATES,
    ROOT,
    bitmap_xml,
    feature_assets,
    geom_xml,
    lat_long_sphere,
    textured_xml,
    tm_rmse,
)

torch.set_num_threads(1)

N = 4096
ATOL, RTOL = 2e-6, 1e-5


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return feature_assets(str(tmp_path_factory.mktemp("tex_assets")))


@pytest.fixture(scope="module")
def packs(assets):
    """(port pack, reference pack) of TEXTURED and of the bitmap scene."""
    out = {}
    for name, xml in (("textured", textured_xml(assets, 32, 32)), ("bitmap", bitmap_xml(assets))):
        out[name] = (pack_scene(mt.load_scene_string(xml), "cpu"), jpack_scene(jload_string(xml)))
    return out


@pytest.mark.parametrize("shape", [(64, 64), (37, 23), (1, 5), (256, 512), (3, 1)])
def test_mip_chain_equal(shape):
    img = np.random.default_rng(sum(shape)).random(shape + (3,)).astype(np.float32)
    ref, out = jbuilder._mip_chain(img), tbuilder._mip_chain(img)
    assert len(out) == len(ref) and out[-1].shape[:2] == (1, 1)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["textured", "bitmap"])
def test_texture_tables_equal(packs, name):
    """The texture table, the atlas and every level's rect, the uv
    partials, the bump, irawan and geometry tables, and the meta."""
    tp, jp = packs[name]
    keys = [k for k in SLICE_ARRAYS] + [k for k in GEOM_TEX_ARRAYS if k in jp.arrays]
    assert (name == "textured") == ("tri_kh" in keys)
    for k in keys:
        ref = np.asarray(jp.arrays[k])
        assert tp.arrays[k].numpy().dtype == ref.dtype, k
        if k == "tex_atlas" and name == "bitmap":
            # checker.png is LDR: the sRGB curve's float32 pow is numpy's in
            # the port and XLA's in the reference, one last place apart
            np.testing.assert_allclose(tp.arrays[k].numpy(), ref, rtol=2.4e-7, atol=0, err_msg=k)
            continue
        np.testing.assert_array_equal(tp.arrays[k].numpy(), ref, err_msg=k)
    for k in SLICE_META:
        assert tp.meta[k] == jp.meta[k], k
    assert tp.meta["has_mips"] and tp.tex_atlas.shape[0] > 1


def test_textured_meta(packs):
    """TEXTURED holds what the slice renders: diffuse, roughplastic and
    irawan, the three geometry kinds, bump and normal maps, seven textures
    with their mip levels, and more than 512 triangles (the pair
    pipeline)."""
    tp, _ = packs["textured"]
    assert tp.meta["present_types"] == (0, 8, 17)
    assert tp.meta["geom_tex_kinds"] == (4, 5, 6)
    assert tp.meta["has_bumpmaps"] and tp.meta["has_irawan"] and not tp.meta["iw_noise"]
    assert tp.meta["n_tris"] == 2758 and tp.meta["use_bvh"] and tp.meta["n_spheres"] == 1
    assert tp.tex_n_lev.tolist() == [10, 7, 1, 8, 1, 1, 1]
    assert tuple(tp.tex_atlas.shape) == (448, 512, 3)


def test_vertex_curvatures_equal(assets):
    """On the welded 24 x 12 sphere and on a seeded displaced mesh."""
    for mesh in (load_ply(os.path.join(assets, "ball.ply"))[0],
                 types.SimpleNamespace(positions=lat_long_sphere(16, 9)[0] * np.float32(1.3),
                                       indices=lat_long_sphere(16, 9)[1])):
        for a, b in zip(tbuilder._vertex_curvatures(mesh), jbuilder._vertex_curvatures(mesh)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ply_colors_equal(assets):
    for f in ("ball.ply", "quad.ply"):
        a, b = load_ply(os.path.join(assets, f))[0], jload_ply(os.path.join(assets, f))[0]
        assert a.colors.dtype == b.colors.dtype == np.float32
        np.testing.assert_array_equal(a.colors, b.colors)
        np.testing.assert_array_equal(a.positions, b.positions)


def _lanes(pack, seed, kinds=None):
    """Random texture ids (of `kinds` when given, -1 on a tenth of the
    lanes), uv in [-2, 3) and defaults."""
    rng = np.random.default_rng(seed)
    types_ = pack.tex_type.numpy()
    ids = np.arange(len(types_)) if kinds is None else np.nonzero(np.isin(types_, kinds))[0]
    tid = rng.choice(ids, N).astype(np.int32)
    tid[: N // 10] = -1
    uv = rng.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    default = rng.random((N, 3)).astype(np.float32)
    return tid, uv, default


def _ellipse(seed):
    """(minor_uv, major_uv) of footprints from a texel to a tenth of the
    texture, anisotropy up to ~16."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, np.pi, N)
    r = 10.0 ** rng.uniform(-3.5, -1.0, N)
    minor = np.stack([np.cos(ang), np.sin(ang)], -1) * r[:, None]
    major = np.stack([-np.sin(ang), np.cos(ang)], -1) * (r * rng.uniform(1, 16, N))[:, None]
    return minor.astype(np.float32), major.astype(np.float32)


def _eval_both(packs, name, tid, uv, default, fp=None, geom=None):
    tp, jp = packs[name]
    conv = (lambda x: tuple(map(jnp.asarray, x)) if isinstance(x, tuple) else jnp.asarray(x))
    tconv = (lambda x: tuple(map(torch.as_tensor, x)) if isinstance(x, tuple)
             else torch.as_tensor(x))
    ref = np.asarray(jtex.eval_texture(jp, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(default),
                                       None if fp is None else conv(fp),
                                       None if geom is None else conv(geom)))
    out = ttex.eval_texture(tp, torch.as_tensor(tid), torch.as_tensor(uv), torch.as_tensor(default),
                            None if fp is None else tconv(fp),
                            None if geom is None else tconv(geom)).numpy()
    return out, ref


ARMS = ("level0", "trilinear", "feline", "ewa")


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("name", ["textured", "bitmap"])
def test_eval_texture_bitmap_arms(packs, name, arm, monkeypatch):
    """Every texture of the pack (the bitmap scene's nearest-filtered
    and sRGB-linearized ones included) through each bitmap arm."""
    tid, uv, default = _lanes(packs[name][0], ARMS.index(arm) + 10 * (name == "bitmap"))
    fp = None
    if arm == "trilinear":
        fp = (10.0 ** np.random.default_rng(3).uniform(-4, 0, N)).astype(np.float32)
    elif arm in ("feline", "ewa"):
        fp = _ellipse(4)
    if arm == "ewa":
        monkeypatch.setattr(jtex, "TEX_FILTER", "ewa")
        monkeypatch.setattr(ttex, "TEX_FILTER", "ewa")
    out, ref = _eval_both(packs, name, tid, uv, default, fp)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    if arm != "level0":  # the footprint changed the bitmaps' values
        lvl0, _ = _eval_both(packs, name, tid, uv, default)
        assert np.abs(lvl0 - out).max() > 1e-2


def test_isotropic_probes_without_aniso(packs, monkeypatch):
    """MTS_TEX_ANISO = 1: an ellipse takes the trilinear arm."""
    monkeypatch.setattr(jtex, "TEX_ANISO", 1)
    monkeypatch.setattr(ttex, "TEX_ANISO", 1)
    tid, uv, default = _lanes(packs["bitmap"][0], 5)
    out, ref = _eval_both(packs, "bitmap", tid, uv, default, _ellipse(6))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_eval_texture_procedural_and_geometry(packs):
    """grid, bitmap and the geometry kinds of TEXTURED on triangle lanes
    (random triangles and barycentrics), no footprint."""
    tp, _ = packs["textured"]
    tid, uv, default = _lanes(tp, 7)
    rng = np.random.default_rng(8)
    prim = rng.integers(0, tp.meta["n_tris"], N).astype(np.int32)
    b = rng.random((N, 2)).astype(np.float32)
    b = np.where(b.sum(-1, keepdims=True) > 1, 1 - b, b).astype(np.float32)
    out, ref = _eval_both(packs, "textured", tid, uv, default, geom=(prim, b))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    kinds = tp.tex_type.numpy()[np.maximum(tid, 0)]
    for k in (3, 4, 5, 6):  # each kind gave colour on some lane
        assert (out[(kinds == k) & (tid >= 0)] > 0).any(), k


def test_geometry_kinds_off_triangles(packs):
    """The gather trap: geometry-kind lanes whose prim is not a triangle
    (a sphere's id, an id past the padded tables, -1) give the
    reference's values, which clamp the id into the triangle tables, and
    raise nothing."""
    tp, _ = packs["textured"]
    tid, uv, default = _lanes(tp, 9, kinds=(4, 5, 6))
    rng = np.random.default_rng(10)
    rows = tp.tri_c0.shape[0]
    prim = rng.choice(np.array([-1, 0, 1, rows - 1, rows, rows + 7, 10 ** 6], np.int32), N)
    b = (rng.random((N, 2)) * 0.5).astype(np.float32)
    out, ref = _eval_both(packs, "textured", tid, uv, default, geom=(prim, b))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def _its(seed, n=N):
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    ns = unit(rng.normal(size=(n, 3)))
    wi = unit(rng.normal(size=(n, 3)))
    wi = np.where((np.sum(wi * ns, -1) < 0)[:, None], -wi, wi).astype(np.float32)
    dpdu = (rng.normal(size=(n, 3)) * rng.uniform(0.1, 5, (n, 1))).astype(np.float32)
    dpdv = (rng.normal(size=(n, 3)) * rng.uniform(0.1, 5, (n, 1))).astype(np.float32)
    dpdu[:8] = 0.0  # degenerate partials
    t = rng.uniform(0.1, 20.0, n).astype(np.float32)
    return dict(t=t, ns=ns, wi_world=wi, dpdu=dpdu, dpdv=dpdv)


@pytest.mark.parametrize("aniso", [4, 1])
def test_mip_footprint(packs, aniso, monkeypatch):
    monkeypatch.setattr(jtex, "TEX_ANISO", aniso)
    monkeypatch.setattr(ttex, "TEX_ANISO", aniso)
    tp, jp = packs["bitmap"]
    its = _its(11)
    ref = jtex.mip_footprint(jp, types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in its.items()}))
    out = ttex.mip_footprint(tp, types.SimpleNamespace(
        **{k: torch.as_tensor(v) for k, v in its.items()}))
    if aniso == 1:  # the scalar diameter
        out, ref = (out,), (ref,)
    for a, b in zip(out, ref):
        a, b = a.numpy(), np.asarray(b)
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-7)
        assert np.quantile(rel, 0.999) < 1e-4 and rel.max() < 1e-3, (np.quantile(rel, 0.999),
                                                                     rel.max())
    # no footprint without mip maps or a camera
    assert ttex.mip_footprint(types.SimpleNamespace(meta={"has_mips": False}), None) is None


def test_shading_params_without_interaction(packs):
    """sppm's stored points shade without an interaction: the geometry
    kinds give their constant colour times scale, as the reference's."""
    tp, jp = packs["textured"]
    rng = np.random.default_rng(12)
    mat = rng.integers(0, tp.mat_type.shape[0], N).astype(np.int32)
    uv = rng.random((N, 2)).astype(np.float32)
    ref = jtex.shading_params(jp, jnp.asarray(mat), jnp.asarray(uv))
    out = ttex.shading_params(tp, torch.as_tensor(mat), torch.as_tensor(uv))
    np.testing.assert_allclose(out["cA"].numpy(), np.asarray(ref["cA"]), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("golden,make", [
    ("torch_textured_32_4.npy", lambda d: textured_xml(d, 32, 32)),
    ("torch_tex_bitmap_24_4.npy", bitmap_xml),
    ("torch_tex_bitmap_ewa_24_4.npy", bitmap_xml),
    ("torch_tex_vertexcolors_33_4.npy", lambda d: geom_xml("vertexcolors", d)),
    ("torch_tex_wireframe_33_4.npy", lambda d: geom_xml("wireframe", d)),
    ("torch_tex_curvature_33_4.npy", lambda d: geom_xml("curvature", d)),
], ids=["textured", "bitmap", "bitmap_ewa", "vertexcolors", "wireframe", "curvature"])
def test_texture_goldens(assets, golden, make, monkeypatch):
    """TEXTURED at 32 x 32 and the feature scenes, 4 spp, against the JAX
    package's renders (tests/make_torch_bigmesh_golden.py)."""
    if "ewa" in golden:
        monkeypatch.setattr(ttex, "TEX_FILTER", "ewa")
    img = mt.render(mt.load_scene_string(make(assets)), spp=4, seed=0, device="cpu")
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert tm_rmse(img, ref) < GOLDEN_GATES[golden]


def test_texture_plugins_registered():
    """The nine plugins of the slice load; the registry refuses an
    unknown texture by name."""
    from mitsuba_tpu_torch.scene import registry

    names = set(registry.names("texture"))
    assert {"bitmap", "gridtexture", "scale", "vertexcolors", "wireframe", "curvature",
            "checkerboard"} <= names
    assert {"bumpmap", "normalmap", "irawan"} <= set(registry.names("bsdf"))
    with pytest.raises(NotImplementedError, match="texture 'marble' not yet ported"):
        mt.load_scene_string('<scene version="0.5.0"><shape type="rectangle"><bsdf type="diffuse">'
                             '<texture name="reflectance" type="marble"/></bsdf></shape></scene>')
