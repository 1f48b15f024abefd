"""The port's VPL integrator (mitsuba_tpu_torch/integrator/vpl.py) against
the reference (mitsuba_tpu/integrator/vpl.py): the VPLs of a light walk
on scenes/cbox.xml and on tests/test_bdpt.py's two-wall scene under its
spot light, one pass of cbox at 24x24, a whole render against the
reference's golden, and the `clamping` property, which no code of the
reference reads.

Tolerances:

* the VPLs: kinds and materials equal; positions atol 1e-3 (2e-6 of
  cbox's 560 units), normals, directions and uv rtol 1e-5, atol 1e-5,
  weights rtol 1e-4 (a vertex several bounces deep carries the
  last-place differences of each sampled direction), on 99 % of the
  VPLs; a light path that a last-place difference sends elsewhere moves
  the VPLs after it;
* one pass: rtol 1e-3, atol 1e-5 on 95 % of the pixels, the image's
  mean within 2 %.  The camera's hit t differs by an ulp between the
  packages (ROADMAP C, "cbox 7.8e-4"), which at t ~ 900 moves the hit
  point by ~6e-5 across the face; the shadow ray's 1e-4 offset then
  leaves it on either side of the face, and a VPL seen at a grazing
  angle is blocked by the face itself in one package and not in the
  other.  On the short box's camera-facing side, lit at grazing angles
  from the right, that takes whole pixels (14 of 576 differ at pass 2,
  measured);
* the golden: tests/torch_meshes.py GOLDEN_GATES.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.integrator import vpl as jvpl
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.integrator import vpl as tvpl
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import (
    GOLDEN_GATES,
    ROOT,
    cbox_xml,
    tm_rmse,
    two_wall_xml,
    with_properties,
)

torch.set_num_threads(1)

W = 24
SCENES = {"cbox": lambda: cbox_xml("vpl", W, W),
          "spot": lambda: two_wall_xml("spot", "vpl", max_depth=8, spp=4)}


def _packs(xml):
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    return ts, js, pack_scene(ts, "cpu"), jpack_scene(js)


@pytest.mark.parametrize("name,pass_i", [("cbox", 0), ("cbox", 5), ("spot", 1)])
def test_generate_vpls(name, pass_i):
    """Positions, normals, directions, weights, kinds, materials and uv
    of 256 light walks of 6 bounces."""
    _, _, tp, jp = _packs(SCENES[name]())
    n_vpl, depth = 256, 6
    ref = jvpl._generate_vpls(jp, n_vpl, depth, jnp.uint32(pass_i), 3, jp.present_types)
    got = tvpl._generate_vpls(tp, n_vpl, depth, pass_i, 3, tp.meta["present_types"],
                              torch.device("cpu"))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["kind"].shape == (n_vpl * (depth + 1),)
    close = np.ones(len(ref["kind"]), bool)
    for k in ("kind", "mat"):
        close &= got[k] == ref[k]
    live = ref["kind"] >= 0
    for k, tol in (("p", dict(rtol=1e-5, atol=1e-3)), ("n", dict(rtol=1e-5, atol=1e-5)),
                   ("wi", dict(rtol=1e-5, atol=1e-5)), ("uv", dict(rtol=1e-5, atol=1e-5)),
                   ("w", dict(rtol=1e-4, atol=1e-6))):
        ok = np.isclose(got[k], ref[k], **tol).reshape(len(close), -1).all(-1)
        close &= ok | ~live  # a dead VPL's vertex is not read
    assert close.mean() > 0.99, close.mean()
    assert live.mean() > 0.3 and (ref["kind"][:n_vpl] != 1).all()


def test_one_pass():
    """One pass on cbox (pass 2: its VPLs, the eye walk and every VPL's
    shadow batch) against the reference's."""
    ts, js, tp, jp = _packs(SCENES["cbox"]())
    zeros = np.zeros((W, W, 3), np.float32)
    ref = jvpl.make_vpl_pass(jp, js.integrator, js.sensor.record, W, W, 0)(
        jnp.asarray(zeros), jnp.uint32(2))
    one = tvpl.make_vpl_pass(tp, ts.integrator, ts.sensor.record, W, W, 0, torch.device("cpu"))
    got = one(torch.zeros(W, W, 3), 2).numpy()
    ref = np.asarray(ref)
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() > 0.95, close.mean()
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=0.02)
    assert one.stats["vpls"] > 64


def test_meets_golden():
    """scenes/cbox.xml (maxDepth 16: 6-bounce light walks) at 24x24 under
    vpl, 4 passes of 64 VPL paths, seed 0, through `render`, against the
    reference's render (tests/golden/torch_cbox_vpl_24_4.npy)."""
    name = "torch_cbox_vpl_24_4.npy"
    golden = np.load(os.path.join(ROOT, "tests", "golden", name))
    out = mt.render(mt.load_scene_string(SCENES["cbox"]()), spp=4, seed=0, device="cpu")
    assert out.shape == golden.shape
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)


@pytest.mark.parametrize("value,refused", [("0.1", False), ("0.05", True), ("0.3", True)])
def test_clamping(value, refused):
    """The reference's vpl pass clamps at 0.1 scene radii and reads no
    property: any other `clamping` is refused by name."""
    xml = with_properties(SCENES["cbox"](), f'<float name="clamping" value="{value}"/>')
    if refused:
        with pytest.raises(NotImplementedError, match="clamping"):
            mt.load_scene_string(xml)
    else:
        assert mt.load_scene_string(xml).integrator.kind == "vpl"
