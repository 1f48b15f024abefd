"""The port's volumetric photon mapper (mitsuba_tpu_torch/integrator/
photonmapper.py) against the reference (mitsuba_tpu/integrator/
photonmapper.py) on tests/test_photonmapper.py's homogeneous slab
(tests/torch_meshes.py HOMOG_SLAB_XML; 32x32, maxDepth 6): the two photon
maps (2^13 photons, walks of maxDepth 4), the beam radiance estimate on
fixed rays, the eye pass fed the reference's maps, a whole render (2^12
photons an iteration) against the
reference's golden, and the scene without its medium, which is sppm's.

The slab's cube stands on the floor: its null bottom face and the floor
lie in one plane, and a ray that reaches the floor beneath the cube meets
both at the same t.  The reference's two traversals break that tie apart
(its pair pipeline, which the port's kernels follow, takes the floor; its
XLA BVH walk the cube's face; ROADMAP C), and its pair pipeline runs
here only in interpret mode, minutes per pass.  So the golden, the slab
as it stands, comes from the pair pipeline
(tests/make_torch_bigmesh_golden.py), and the pass-level tests run the
reference's XLA walk on the slab with its cube raised 0.01 off the floor
(`homog_slab_xml(lift=0.01)`), where no tie is left.  The photon counts
are passed explicitly: tests/test_photonmapper.py writes MTS_SPPM_PHOTONS
into the environment when it is imported.

Tolerances:

* the volume map: the same photons; cell ids equal except for photons
  within 1e-5 of a cell face; positions, directions and powers within
  rtol 1e-4, atol 1e-4 for 99 % of the photons (a photon a few
  scattering events deep carries the last-place differences of each
  sampled distance's log, up to 2e-5 measured; a grazing bounce off the
  floor amplifies them: 1 photon of 429 at 3e-3); the radii within rtol 1e-6 (pow(x, 1/3) for the
  reference's cbrt: measured equal on these photons);
* the surface map: 98 % of the reference's surface photons have their
  twin in the port's map (position atol 1e-4, power rtol 1e-4), and the
  counts agree within 2 %;
* the beam query on fixed rays: rtol 1e-4, atol 1e-6;
* the eye pass fed the reference's maps (maxDepth 2: the null crossing,
  then the medium's beam query and the floor's gather): L, M and tau
  within rtol 1e-3, atol 1e-5 on 99 % of the pixels, and their sums
  within 1 %;
* the golden: tests/torch_meshes.py GOLDEN_GATES;
* without media: render_sppm's image, bit for bit.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.integrator import photonmapper as jpm
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.integrator import photonmapper as tpm
from mitsuba_tpu_torch.integrator import sppm as tsppm
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import GOLDEN_GATES, ROOT, cbox_xml, homog_slab_xml, tm_rmse

torch.set_num_threads(1)

W = 32
N_PHOTONS = 1 << 12
N_MAP = 1 << 13  # photons of the pass-level tests
LIFT = 0.01
MAP_DEPTH = 4  # the map tests' walks (RR from the third real event on)
CELL_S = 0.2  # a surface grid cell (the slab's first iteration: 2 r0 = 0.1875)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def slab():
    xml = homog_slab_xml(lift=LIFT)
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    return ts, js, pack_scene(ts, "cpu"), jpack_scene(js)


@pytest.fixture(scope="module")
def maps(slab):
    """Both packages' maps of iterations 0 and 1 (2^13 photons, seed 0)."""
    _, _, tp, jp = slab
    t_pass, t_meta = tpm.make_photon_pass(tp, MAP_DEPTH, 0, CPU)
    j_pass, j_meta = jpm.make_photon_pass(jp, MAP_DEPTH, 0)
    # jitted, as the reference's render runs it (its eager walk is slower
    # than one compile for both iterations)
    j_run = jax.jit(lambda it: j_pass(jnp.arange(N_MAP, dtype=jnp.uint32), it, CELL_S))
    out = {}
    for it in (0, 1):
        ref = j_run(jnp.uint32(it))
        out[it] = t_pass(torch.arange(N_MAP), it, CELL_S), ref
    for k in ("lo", "hi", "extent", "h_v", "vdims", "r_cap"):
        np.testing.assert_array_equal(np.asarray(t_meta[k]), np.asarray(j_meta[k]), err_msg=k)
    return out, t_meta, j_meta


def _np(m):
    return {k: np.asarray(v) for k, v in m.items()}


@pytest.mark.parametrize("it", [0, 1])
def test_volume_map(maps, it):
    """Cell ids, positions, directions, powers and radii of the volume
    photons (the reference's dead slots sort last under the sentinel)."""
    ((vol, _), (jvol, _)), meta = maps[0][it], maps[1]
    jv, n = _np(jvol), vol["cid"].shape[0]
    n_cells = int(np.prod(meta["vdims"]))
    assert n > 20 and (jv["cid"][:n] < n_cells).all() and (jv["cid"][n:] == n_cells).all()
    # a photon within 1e-5 of a cell face may fall on either side of it
    f = (jv["p"][:n] - meta["lo"]) / meta["h_v"]
    on_face = (np.abs(f - np.round(f)) < 1e-5 / meta["h_v"]).any(-1)
    same = vol["cid"].numpy() == jv["cid"][:n]
    assert (same | on_face).all(), np.nonzero(~same & ~on_face)
    close = np.ones(n, bool)
    for k in ("p", "d", "pow"):
        close &= np.isclose(vol[k].numpy(), jv[k][:n], rtol=1e-4, atol=1e-4).all(-1)
    assert (close & same).mean() > 0.99, (close & same).mean()
    np.testing.assert_allclose(vol["r"].numpy()[same], jv["r"][:n][same], rtol=1e-6)
    assert (vol["r"].numpy() <= meta["r_cap"] * (1 + 1e-6)).all()


@pytest.mark.parametrize("it", [0, 1])
def test_surface_map(maps, it):
    """The surface photons as a set: each of the reference's found in the
    port's map at its position and with its power."""
    (_, surf), (_, jsurf) = maps[0][it]
    js = _np(jsurf)
    np.testing.assert_array_equal(surf["dims"].numpy(), js["dims"])
    n_ref = int((js["cid"] < np.prod(js["dims"])).sum())
    n = surf["cid"].shape[0]
    assert n_ref > 20 and abs(n - n_ref) <= 0.02 * n_ref, (n, n_ref)
    tp_, jp_ = surf["p"].numpy(), js["p"][:n_ref]
    diff = np.abs(jp_[:, None, :] - tp_[None, :, :]).max(-1)
    twin = diff.argmin(1)
    found = (diff.min(1) < 1e-4) & np.isclose(
        surf["pow"].numpy()[twin], js["pow"][:n_ref], rtol=1e-4).all(-1)
    assert found.mean() > 0.98, found.mean()


def _fixed_rays(meta, n=256, seed=4):
    """Seeded rays from the camera's side through the slab, with their
    segment ends and keys."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-0.3, 0.3, n), r.uniform(0.1, 0.8, n),
                  np.full(n, -0.4499)], -1).astype(np.float32)
    d = np.stack([r.normal(0, 0.3, n), r.normal(0, 0.3, n), np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_end = r.uniform(0.2, 0.9, n).astype(np.float32)
    in_med = r.uniform(size=n) < 0.9
    return o, d, t_end, in_med, np.arange(n), np.full(n, 2)


@pytest.mark.parametrize("ev", [0, 2])
def test_bre_segment(slab, maps, ev):
    """The beam radiance estimate over fixed medium segments inside the
    slab, both packages reading the reference's volume map."""
    _, _, tp, jp = slab
    (_, (jvol, _)), t_meta, j_meta = maps[0][0], maps[1], maps[2]
    o, d, t_end, in_med, lane, sidx = _fixed_rays(t_meta)
    med = np.zeros(len(o), np.int32)
    ref = jpm._bre_segment(jp, j_meta, jvol, jnp.asarray(med), jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(t_end), jnp.asarray(in_med), jnp.asarray(lane, jnp.uint32),
                           jnp.asarray(sidx, jnp.uint32), ev, 7, float(N_MAP))
    tvol = {k: torch.as_tensor(np.array(v)) for k, v in jvol.items()}
    got = tpm._bre_segment(tp, t_meta, tvol, torch.as_tensor(med), torch.as_tensor(o),
                           torch.as_tensor(d), torch.as_tensor(t_end), torch.as_tensor(in_med),
                           torch.as_tensor(lane), torch.as_tensor(sidx), ev, 7, float(N_MAP))
    ref = np.asarray(ref)
    assert (ref.max(-1) > 0).mean() > 0.3
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-6)


def test_eye_pass(slab, maps):
    """L, M and tau_i of the eye pass (iteration 1, maxDepth 2), both
    packages reading the reference's maps and radii."""
    ts, js, tp, jp = slab
    t_int, j_int = copy.copy(ts.integrator), copy.copy(js.integrator)
    t_int.max_depth = j_int.max_depth = 2
    (_, (jvol, jsurf)), t_meta, j_meta = maps[0][1], maps[1], maps[2]
    r0 = t_meta["extent"] / W * 2.0
    r2 = np.full(W * W, r0 * r0, np.float32)
    lane = np.arange(W * W)
    j_eye = jpm.make_eye_pass(jp, j_int, js.sensor.record, W, W, 0, j_meta)
    ref = jax.jit(lambda vol, surf, r2: j_eye(jnp.asarray(lane, jnp.uint32), jnp.uint32(1), vol,
                                              surf, r2, float(N_MAP), CELL_S))(
        jvol, jsurf, jnp.asarray(r2))
    t_eye = tpm.make_eye_pass(tp, t_int, ts.sensor.record, W, W, 0, t_meta, CPU)
    tv = {k: torch.as_tensor(np.array(v)) for k, v in jvol.items()}
    tsf = {k: torch.as_tensor(np.array(v)) for k, v in jsurf.items()}
    got = t_eye(torch.as_tensor(lane), 1, tv, tsf, torch.as_tensor(r2), float(N_MAP), CELL_S)
    for k, a, b in zip(("L", "M", "tau"), got, ref):
        a, b = a.numpy().reshape(W * W, -1), np.asarray(b).reshape(W * W, -1)
        close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1)
        assert close.mean() > 0.99, (k, close.mean())
        np.testing.assert_allclose(a.sum(0), b.sum(0), rtol=0.01, err_msg=k)
        assert b.sum() > 0, k


def test_meets_golden(monkeypatch):
    """The slab as it stands under the photon mapper, 4 iterations of 2^12
    photons, seed 0, through `render`, against the reference's render
    (tests/golden/torch_homog_photonmapper_32_4.npy, its pair pipeline)."""
    monkeypatch.setenv("MTS_SPPM_PHOTONS", str(N_PHOTONS))
    name = "torch_homog_photonmapper_32_4.npy"
    golden = np.load(os.path.join(ROOT, "tests", "golden", name))
    out = mt.render(mt.load_scene_string(homog_slab_xml()), spp=4, seed=0, device="cpu")
    assert out.shape == golden.shape and np.isfinite(out).all()
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)
    st = tpm.render_photonmapper.last_stats
    assert st["volume_photons"] > 100 and st["surface_photons"] > 20, st


def test_no_media_is_sppm(monkeypatch):
    """Without its medium the slab is sppm's at sppm's own photon count
    (MTS_SPPM_PHOTONS): the same image, bit for bit."""
    monkeypatch.setenv("MTS_SPPM_PHOTONS", "4096")
    xml = homog_slab_xml(media=False, width=16, height=16)
    sc = mt.load_scene_string(xml)
    pack = pack_scene(sc, "cpu")
    assert not pack.meta.get("has_media", False)
    a = tpm.render_photonmapper(sc, spp=2, seed=1, pack=pack, device="cpu")
    b = tsppm.render_sppm(sc, spp=2, seed=1, pack=pack, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert a.mean() > 0.01


def test_explicit_count_without_media(monkeypatch):
    """Without media an explicit photons_per_pass is dropped, as the
    reference drops it (photonmapper.py:612-615): sppm renders with its own
    count, here MTS_SPPM_PHOTONS = 4,096.  cbox at 16x16, 2 iterations, N =
    8,192: the two packages agree at cbox sppm's gate (GOLDEN_GATES; 1.9e-8
    measured), and the image is not sppm's at N (1.4e-2 measured)."""
    monkeypatch.setenv("MTS_SPPM_PHOTONS", "4096")
    xml = cbox_xml("photonmapper", 16, 16)
    n = 1 << 13
    got = tpm.render_photonmapper(mt.load_scene_string(xml), spp=2, seed=0, photons_per_pass=n,
                                  device="cpu")
    ref = np.asarray(jpm.render_photonmapper(jload_string(xml), spp=2, seed=0,
                                             photons_per_pass=n))
    assert tm_rmse(got, ref) < GOLDEN_GATES["torch_cbox_sppm_24_4.npy"], tm_rmse(got, ref)
    at_n = tsppm.render_sppm(mt.load_scene_string(xml), spp=2, seed=0, photons_per_pass=n,
                             device="cpu")
    assert tm_rmse(got, at_n) > 10 * tm_rmse(got, ref) + 1e-3
