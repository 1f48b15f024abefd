"""The lens draw of every camera, held under a `thinlens` camera, where it
moves each camera ray: the eye passes of the port's sppm
(mitsuba_tpu_torch/integrator/sppm.py) and of its volumetric photon mapper
(integrator/photonmapper.py), and a pass of its vpl (integrator/vpl.py),
against the reference's (mitsuba_tpu/integrator/sppm.py:111-113,
photonmapper.py:426-428: the sampler's counter stream at slot 1009;
vpl.py:144-146: its lens_sample).  The rays through a lens point of zeros
(the pinhole's) part from the reference's everywhere off the focal plane,
and each test fails with them.

Tolerances are those of the pinhole tests of each integrator
(tests/test_torch_sppm.py, test_torch_photonmapper.py, test_torch_vpl.py)
but one: a visible point's coordinates within rtol 1e-5 (atol 1e-3 for
positions), L within rtol 1e-4 on 98 % of the pixels (the pinhole test:
99 %) and its mean within 1 %.  Through the lens a hit point on cbox
moves by up to 3.7e-4 between the packages (measured): the ray starts off
the camera's centre, ~800 units from the origin, with a last place of
6e-5, and its direction's last place grows by the 1,300 units to the back
wall.  That is more than the shadow ray's 1e-4 offset, so a few NEE rays
that graze an edge are blocked in one package only: 7 pixels of 576 at
iteration 0 (98.8 % close), 2 at iteration 3.  The
photon mapper's L, M and tau within rtol 1e-3 on 99 % and their sums
within 1 %; a vpl pass within rtol 1e-3 on 95 % of the pixels and its
mean within 2 %.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.integrator import photonmapper as jpm
from mitsuba_tpu.integrator import sppm as jsppm
from mitsuba_tpu.integrator import vpl as jvpl
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.integrator import photonmapper as tpm
from mitsuba_tpu_torch.integrator import sppm as tsppm
from mitsuba_tpu_torch.integrator import vpl as tvpl
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import cbox_xml, homog_slab_xml, with_thinlens

torch.set_num_threads(1)

CPU = torch.device("cpu")
W = 24
# cbox's camera stands 1,340 units from its back wall: a 30-unit aperture
# focused at 1,000 blurs every wall
CBOX_LENS = (30.0, 1000.0)
VP_FIELDS = ("valid", "p", "ns", "wi", "beta", "mat", "uv")


def _packs(xml):
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    assert ts.sensor.record.pack(8, 8, CPU)["use_lens"]
    return ts, js, pack_scene(ts, "cpu"), jpack_scene(js)


@pytest.fixture(scope="module")
def cbox_sppm():
    return _packs(with_thinlens(cbox_xml("sppm", W, W, max_depth=5), *CBOX_LENS))


@pytest.mark.parametrize("it", [0, 3])
def test_sppm_eye_pass(cbox_sppm, it):
    """sppm's visible points and direct light through the lens."""
    ts, js, tp, jp = cbox_sppm
    t_eye = tsppm.make_sppm_passes(tp, ts.integrator, ts.sensor.record, W, W, 3, CPU)[0]
    j_eye = jsppm.make_sppm_passes(jp, js.integrator, js.sensor.record, W, W, 3)[0]
    lane = np.arange(W * W)
    L_ref, vps_ref = j_eye(jnp.asarray(lane, jnp.uint32), jnp.uint32(it))
    L, vps = t_eye(torch.as_tensor(lane), it)
    valid = np.asarray(vps_ref[0])
    np.testing.assert_array_equal(vps[0].numpy(), valid)
    assert valid.mean() > 0.9
    for k, a, b in zip(VP_FIELDS[1:], vps[1:], vps_ref[1:]):
        a, b = a.numpy()[valid], np.asarray(b)[valid]
        if k == "mat":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3 if k == "p" else 1e-5,
                                       err_msg=k)
    L, L_ref = L.numpy(), np.asarray(L_ref)
    close = np.isclose(L, L_ref, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() > 0.98, close.mean()
    np.testing.assert_allclose(L.mean(), L_ref.mean(), rtol=0.01)


def test_photonmapper_eye_pass():
    """The volumetric photon mapper's eye pass on the slab (its cube
    raised 0.01 off the floor, tests/test_torch_photonmapper.py) through a
    lens of radius 0.08 focused at 1.2, iteration 1, maxDepth 2, both
    packages reading the reference's maps of 2^12 photons."""
    ts, js, tp, jp = _packs(with_thinlens(homog_slab_xml(lift=0.01), 0.08, 1.2))
    w = ts.sensor.record.film.width
    _, t_meta = tpm.make_photon_pass(tp, 4, 0, CPU)
    j_pass, j_meta = jpm.make_photon_pass(jp, 4, 0)
    cell_s, n_map = 0.2, 1 << 12
    jvol, jsurf = jax.jit(lambda it: j_pass(jnp.arange(n_map, dtype=jnp.uint32), it,
                                           cell_s))(jnp.uint32(0))
    t_int, j_int = copy.copy(ts.integrator), copy.copy(js.integrator)
    t_int.max_depth = j_int.max_depth = 2
    r0 = t_meta["extent"] / w * 2.0
    r2 = np.full(w * w, r0 * r0, np.float32)
    lane = np.arange(w * w)
    j_eye = jpm.make_eye_pass(jp, j_int, js.sensor.record, w, w, 0, j_meta)
    tvol = {k: torch.as_tensor(np.array(v)) for k, v in jvol.items()}
    tsurf = {k: torch.as_tensor(np.array(v)) for k, v in jsurf.items()}
    ref = jax.jit(lambda vol, surf, r2: j_eye(jnp.asarray(lane, jnp.uint32), jnp.uint32(1), vol,
                                              surf, r2, float(n_map), cell_s))(
        jvol, jsurf, jnp.asarray(r2))
    t_eye = tpm.make_eye_pass(tp, t_int, ts.sensor.record, w, w, 0, t_meta, CPU)
    got = t_eye(torch.as_tensor(lane), 1, tvol, tsurf, torch.as_tensor(r2), float(n_map), cell_s)
    for k, a, b in zip(("L", "M", "tau"), got, ref):
        a, b = a.numpy().reshape(w * w, -1), np.asarray(b).reshape(w * w, -1)
        close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1)
        assert close.mean() > 0.99, (k, close.mean())
        np.testing.assert_allclose(a.sum(0), b.sum(0), rtol=0.01, err_msg=k)
        assert b.sum() > 0, k


def test_vpl_pass():
    """One vpl pass on cbox (pass 2) through the lens."""
    ts, js, tp, jp = _packs(with_thinlens(cbox_xml("vpl", W, W), *CBOX_LENS))
    zeros = np.zeros((W, W, 3), np.float32)
    ref = jvpl.make_vpl_pass(jp, js.integrator, js.sensor.record, W, W, 0)(
        jnp.asarray(zeros), jnp.uint32(2))
    one = tvpl.make_vpl_pass(tp, ts.integrator, ts.sensor.record, W, W, 0, CPU)
    got = one(torch.zeros(W, W, 3), 2).numpy()
    ref = np.asarray(ref)
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() > 0.95, close.mean()
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=0.02)
