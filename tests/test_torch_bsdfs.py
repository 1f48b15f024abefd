"""The port's BSDFs beyond the materials slice (mitsuba_tpu_torch/bsdf/eval.py,
bsdf/plugins.py, scene/builder.py's mixture and coating rows and
scene/texture_eval.py's row chains) against the reference
(mitsuba_tpu/bsdf/eval.py, bsdf/plugins.py, scene/builder.py,
scene/texture_eval.py): roughdiffuse, thindielectric, phong, ward,
difftrans, hk, twosided, mask, coating, roughcoating, mixturebsdf and
blendbsdf.

Each single type and layer runs on 20,000 lanes with the parameters of
tests/test_bsdf.py's SMOOTH_CASES (built by its make_sp from the
reference's plugins; the port gets the same arrays), random wi and wo (each
below the surface on a quarter of the lanes, not the same quarter) and
sample numbers.  Mixtures and layers also run
through a pack of the layered gallery (tests/torch_meshes.py
`bsdf_gallery_xml`), whose rows the two packages' shading_params chain
alike.

Tolerances (measured on these inputs):

* the plugins' records and the packed material tables: equal;
* bsdf_eval and bsdf_pdf: rtol 5e-4, atol 1e-6, as in
  tests/test_torch_materials.py (largest measured 1.4e-4 relative, hk's
  slab exponentials);
* bsdf_sample: delta and eta equal; wo within atol 2e-4; weight and pdf
  within rtol 5e-2 (atol 1e-4) on every lane and, on 99.9 % of them,
  within rtol 1e-4 for the cases that draw no microfacet normal and 1e-3
  for roughcoating and the mixtures that hold a rough lobe, whose
  direction comes from a sampled normal, as in
  tests/test_torch_materials.py (measured: at most 4.2e-3 on a lane, a
  coated lobe near total internal reflection or a rough coating's sampled
  normal; the 99.9 % quantile at most 1.3e-4, roughcoating);
* the gallery goldens: tests/torch_meshes.py GOLDEN_GATES.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.bsdf import eval as jbsdf
from mitsuba_tpu.scene import texture_eval as jtex
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.bsdf import eval as tbsdf
from mitsuba_tpu_torch.bsdf import plugins as tplug
from mitsuba_tpu_torch.scene import texture_eval as ttex
from mitsuba_tpu_torch.scene.builder import SLICE_ARRAYS, SLICE_META, pack_scene
from tests.test_bsdf import SMOOTH_CASES, make_sp
from tests.torch_meshes import BSDF_GALLERIES, GOLDEN_GATES, ROOT, bsdf_gallery_xml, tm_rmse

torch.set_num_threads(1)

N = 20000
NEW_TYPES = ("roughdiffuse", "phong", "ward", "difftrans", "hk", "coating", "roughcoating")
CASES = [c for c in SMOOTH_CASES if c[0] in NEW_TYPES] + [
    ("thindielectric", {}, None),
    ("thindielectric", {"intIOR": "water"}, None),
    ("twosided", {"nested": ("ward", {"alphaU": 0.1, "alphaV": 0.35})}, None),
    ("twosided", {"nested": ("phong", {"exponent": 8.0})}, None),
]
# the cases whose sample draws a microfacet normal
SAMPLED_NORMAL = ("roughcoating",)


def _dirs(seed, below=0.25):
    d = np.random.default_rng(seed).normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2])
    d[: int(N * below), 2] *= -1.0
    return d


def _to_torch(sp):
    return {k: _to_torch(v) if isinstance(v, dict) else
            v if isinstance(v, tuple) or v is None else torch.as_tensor(np.asarray(v))
            for k, v in sp.items()}


def _close_most(out, ref, name, most):
    """rtol `most` on 99.9 % of the values and 5e-2 on all (atol 1e-4)."""
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-4)
    assert np.quantile(rel, 0.999) < most, (name, np.quantile(rel, 0.999))
    assert rel.max() < 5e-2, (name, rel.max())


def _compare(jsp, tsp, present, rough, seed=0):
    wi, wo = _dirs(seed), _dirs(seed + 1)[::-1].copy()  # each below on its own quarter
    u = np.random.default_rng(seed + 2).uniform(0, 1, (N, 3)).astype(np.float32)
    for fn in ("bsdf_eval", "bsdf_pdf"):
        ref = np.asarray(getattr(jbsdf, fn)(jsp, jnp.asarray(wi), jnp.asarray(wo), present))
        out = getattr(tbsdf, fn)(tsp, torch.as_tensor(wi), torch.as_tensor(wo), present).numpy()
        np.testing.assert_allclose(out, ref, rtol=5e-4, atol=1e-6, err_msg=fn)
        assert (ref > 0).any() or set(present) <= set(tbsdf.DELTA_TYPES), fn  # a live lobe
    ref = jbsdf.bsdf_sample(jsp, jnp.asarray(wi), jnp.asarray(u[:, :2]), jnp.asarray(u[:, 2]),
                            present)
    out = tbsdf.bsdf_sample(tsp, torch.as_tensor(wi), torch.as_tensor(u[:, :2]),
                            torch.as_tensor(u[:, 2]), present)
    np.testing.assert_array_equal(out.delta.numpy(), np.asarray(ref.delta))
    np.testing.assert_array_equal(out.eta.numpy(), np.asarray(ref.eta))
    np.testing.assert_allclose(out.wo.numpy(), np.asarray(ref.wo), rtol=0, atol=2e-4)
    for k in ("weight", "pdf"):
        _close_most(getattr(out, k).numpy(), np.asarray(getattr(ref, k)), k, 1e-3 if rough else 1e-4)
    w = out.weight.numpy()
    assert np.isfinite(w).all() and (w > 0).any()
    return out


@pytest.mark.parametrize("name,props,_", CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CASES)])
def test_bsdf_functions(name, props, _):
    jsp, present = make_sp(N, name, **props)
    out = _compare(jsp, _to_torch(jsp), present, name in SAMPLED_NORMAL)
    if name == "thindielectric":
        assert out.delta.numpy().all()
    if name == "hk":
        assert not out.delta.numpy().all()


def _record(xml_bsdf, load):
    scene = load(f"""<scene version="0.5.0"><sensor type="perspective"/>
        <shape type="rectangle">{xml_bsdf}</shape></scene>""")
    return scene.shapes[0].bsdf


@pytest.mark.parametrize("xml", [b for g in BSDF_GALLERIES.values() for b in g],
                         ids=lambda x: x.split('"')[1])
def test_plugin_records_equal(xml):
    """Every gallery BSDF's record, nested records included."""
    def fields(rec):
        out = {k: getattr(rec, k) for k in (
            "type", "cA", "cB", "cC", "cD", "alpha_u", "alpha_v", "eta", "exponent", "dist",
            "nonlinear", "twosided", "fdr_int", "spec_sampling_weight", "opacity", "weights")}
        out["children"] = [fields(c) for c in rec.children]
        return out

    def equal(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                equal(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                equal(x, y)
        elif a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    equal(fields(_record(xml, mt.load_scene_string)), fields(_record(xml, jload_string)))


@pytest.fixture(scope="module")
def layered():
    xml = bsdf_gallery_xml("layered", 24, 24)
    return pack_scene(mt.load_scene_string(xml), "cpu"), jpack_scene(jload_string(xml))


def test_layered_pack_equal(layered):
    """The rows of the mask over a coating, the rough coating, and the
    mixture's chain (its blend flattened into it: four leaves)."""
    tp, jp = layered
    for k in SLICE_ARRAYS:
        ref = np.asarray(jp.arrays[k])
        assert tp.arrays[k].numpy().dtype == ref.dtype, k
        np.testing.assert_array_equal(tp.arrays[k].numpy(), ref, err_msg=k)
    for k in SLICE_META:
        assert tp.meta[k] == jp.meta[k], k
    assert tp.meta["has_mixtures"] and tp.meta["mix_depth"] == 3
    assert (tp.mat_mix_b.numpy() >= 0).sum() == 5  # 2 layers, the mixture's 3 links
    assert (tp.mat_opacity.numpy() == 0.5).all(axis=-1).sum() == 1  # the mask's row


def _chain_equal(tsp, jsp, path="sp"):
    assert set(tsp) <= set(jsp), path  # the port gathers what the present types read
    for k, v in tsp.items():
        if k == "mix":
            _chain_equal(v["spB"], jsp[k]["spB"], path + ".mix.spB")
            for w in ("wa", "wb"):
                np.testing.assert_array_equal(v[w].numpy(), np.asarray(jsp[k][w]), err_msg=w)
        elif k != "mf_dists":
            np.testing.assert_array_equal(v.numpy(), np.asarray(jsp[k]), err_msg=f"{path}.{k}")
    assert tsp["mf_dists"] == jsp["mf_dists"]


def _lane_params(tp, jp, seed):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, tp.mat_type.shape[0], N).astype(np.int32)
    uv = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    jsp = jtex.shading_params(jp, jnp.asarray(mat), jnp.asarray(uv))
    tsp = ttex.shading_params(tp, torch.as_tensor(mat), torch.as_tensor(uv))
    _chain_equal(tsp, jsp)
    return jsp, tsp


def test_layered_chain_eval_pdf(layered):
    """shading_params follows the mixture and coating links as the
    reference does (mix_depth 3 hops), and eval and pdf agree on random
    rows of the layered gallery.  (Its sample: the golden below; the
    reference's eager sample of a 3-hop chain takes half a minute.)"""
    tp, jp = layered
    jsp, tsp = _lane_params(tp, jp, 7)
    wi, wo = _dirs(8), _dirs(9)[::-1].copy()
    for fn in ("bsdf_eval", "bsdf_pdf"):
        ref = np.asarray(getattr(jbsdf, fn)(jsp, jnp.asarray(wi), jnp.asarray(wo),
                                            tp.meta["present_types"]))
        out = getattr(tbsdf, fn)(tsp, torch.as_tensor(wi), torch.as_tensor(wo),
                                 tp.meta["present_types"]).numpy()
        np.testing.assert_allclose(out, ref, rtol=5e-4, atol=1e-6, err_msg=fn)


LAYERS_XML = """<scene version="0.5.0"><sensor type="perspective"/>
  <shape type="rectangle"><bsdf type="coating"><float name="thickness" value="2"/>
    <rgb name="sigmaA" value="0.3, 0.1, 0.5"/><bsdf type="phong"/></bsdf></shape>
  <shape type="rectangle"><bsdf type="twosided"><bsdf type="roughcoating">
    <float name="alpha" value="0.3"/><bsdf type="diffuse"/></bsdf></bsdf></shape>
  <shape type="rectangle"><bsdf type="blendbsdf"><float name="weight" value="0.35"/>
    <bsdf type="diffuse"/><bsdf type="roughconductor"><float name="alpha" value="0.2"/></bsdf>
  </bsdf></shape>
  <shape type="rectangle"><bsdf type="mixturebsdf"><string name="weights" value="0.5 0.3"/>
    <bsdf type="roughplastic"/><bsdf type="coating"><bsdf type="conductor"/></bsdf></bsdf></shape>
</scene>"""


def test_layers_and_mixtures_functions():
    """eval, pdf and sample on random rows of one-hop chains: a coating
    over phong, a two-sided rough coating over diffuse, a blend, and a
    two-leaf mixture of weights 0.5 and 0.3 (the deficit absorbed) holding
    a coated mirror (a delta child)."""
    tp = pack_scene(mt.load_scene_string(LAYERS_XML), "cpu")
    jp = jpack_scene(jload_string(LAYERS_XML))
    assert tp.meta["mix_depth"] == jp.meta["mix_depth"] == 1
    jsp, tsp = _lane_params(tp, jp, 10)
    out = _compare(jsp, tsp, tp.meta["present_types"], True, seed=11)
    assert out.delta.numpy().any() and not out.delta.numpy().all()


@pytest.mark.parametrize("golden,kind,integrator", [
    ("torch_bsdf_glossy_24_4.npy", "glossy", None),
    ("torch_bsdf_thin_24_4.npy", "thin", None),
    ("torch_bsdf_layered_24_4.npy", "layered", None),
    ("torch_bsdf_thin_bdpt_24_4.npy", "thin", "bdpt"),
])
def test_gallery_golden(golden, kind, integrator):
    """The matpreview variant with its spheres' BSDFs replaced, at 24x24
    and 4 spp, against the JAX package's render (bdpt at maxDepth 4)."""
    xml = bsdf_gallery_xml(kind, 24, 24, integrator, 4 if integrator else None)
    img = mt.render(mt.load_scene_string(xml), spp=4, seed=0, device="cpu")
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert tm_rmse(img, ref) < GOLDEN_GATES[golden]


def test_unported_plugins_refused():
    """Every BSDF plugin of the reference is registered (bumpmap,
    normalmap and irawan since the texture slice) and every type
    evaluated; the registry still refuses a plugin it does not hold, by
    name."""
    for name in ("bumpmap", "normalmap"):
        rec = _record(f'<bsdf type="{name}"><texture type="checkerboard"/>'
                      '<bsdf type="diffuse"/></bsdf>', mt.load_scene_string)
        assert rec.tex_bump is not None and rec.bump_is_normalmap == (name == "normalmap")
    assert _record('<bsdf type="irawan"/>', mt.load_scene_string).type == tplug.IRAWAN
    assert tplug.IRAWAN in tbsdf.PORTED
    with pytest.raises(NotImplementedError, match="bsdf 'velvet' not yet ported"):
        _record('<bsdf type="velvet"/>', mt.load_scene_string)
