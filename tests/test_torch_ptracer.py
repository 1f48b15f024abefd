"""The port's particle tracer and the light image's splat against the
reference (mitsuba_tpu/integrator/ptracer.py, mitsuba_tpu/film/film.py
`splat_add`) on seeded numpy inputs: the emission of every emitter kind,
the filtered splat, renders of cbox and of a spot and a directional light
at 16x16, 4 particles per pixel, and cbox at 64x64, 16 particles per
pixel, against the reference's golden (maxDepth 16, deeper than a live
render here affords).

Function-level tolerance: rtol 1e-5, atol 1e-6 (emission vectors atol
2e-6; the envmap's emission rtol 1e-3, atol 1e-5: ROADMAP C, "The
envmap's functions"); renders against the reference live: tone-mapped
RMSE < 5e-3, the gate of tests/test_golden.py; against the golden:
tests/torch_meshes.py GOLDEN_GATES (1e-5), a few times above the port's
readings."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu
import mitsuba_tpu_torch as mt
from mitsuba_tpu.film import film as jfilm
from mitsuba_tpu.film.plugins import RFilterRecord as JRFilter
from mitsuba_tpu.integrator import ptracer as jpt
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.film import film as tfilm
from mitsuba_tpu_torch.film.plugins import RFilterRecord as TRFilter
from mitsuba_tpu_torch.integrator import ptracer as tpt
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.test_torch_bdpt import LIGHT_SCENES
from tests.torch_meshes import (
    GOLDEN_GATES,
    ROOT,
    cbox_ptracer_xml,
    two_wall_xml,
    with_integrator,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_ENV = dict(rtol=1e-3, atol=1e-5)
N = 2048


def _close(out, ref, tol=TOL, **kw):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol, **kw)


def _tm_rmse(a, b):
    return float(np.sqrt(np.mean((a / (1 + a) - b / (1 + b)) ** 2)))


@pytest.mark.parametrize("name", list(LIGHT_SCENES))
def test_sample_emitter_ray(name):
    """Each kind's emission: position, normal, direction, throughput."""
    xml = with_integrator(LIGHT_SCENES[name], "ptracer")
    jp = jpack_scene(jload_string(xml))
    tp = pack_scene(mt.load_scene_string(xml), "cpu")
    r = np.random.default_rng(8)
    lane = r.integers(0, 1 << 20, N).astype(np.uint32)
    sidx = r.integers(0, 64, N).astype(np.uint32)
    ref = jpt._sample_emitter_ray(jp, jnp.asarray(lane), jnp.asarray(sidx), 5)
    out = tpt._sample_emitter_ray(tp, torch.as_tensor(lane.astype(np.int64)),
                                  torch.as_tensor(sidx.astype(np.int64)), 5)
    # unit vectors from the cosine warp's sin / cos and a normalization:
    # up to 1.3e-6 apart on a component near 0 (measured)
    tol = TOL_ENV if name == "envmap" else dict(rtol=1e-5, atol=2e-6)
    for i, k in enumerate(("p", "n", "d", "beta")):
        _close(out[i], ref[i], tol, err_msg=k)
    for i, k in ((4, "is_area"), (5, "e")):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]), err_msg=k)
    assert (out[3].numpy().max(-1) > 0).mean() > 0.5


@pytest.mark.parametrize("kind,radius", [(0, 0.5), (1, 1.0), (2, 2.0), (3, 2.0)])
def test_splat_add(kind, radius):
    """The light image's filtered splat (box, tent, gaussian, mitchell):
    positions inside, on the edge of and off the film, NaN and infinite
    positions and values, and a validity mask."""
    h, w = 12, 16
    r = np.random.default_rng(9 + kind)
    pos = r.uniform(-2, 18, (N, 2)).astype(np.float32)
    pos[::17] = np.nan
    pos[5::23, 1] = np.inf
    val = r.uniform(0, 3, (N, 3)).astype(np.float32)
    val[3::29] = np.nan
    valid = r.uniform(size=N) < 0.8
    img = r.uniform(0, 1, (h, w, 3)).astype(np.float32)
    recs = (JRFilter(kind=kind, radius=radius), TRFilter(kind=kind, radius=radius))
    ref = jfilm.splat_add(jnp.asarray(img), jnp.asarray(pos), jnp.asarray(val), recs[0],
                          valid=jnp.asarray(valid))
    out = tfilm.splat_add(torch.as_tensor(img), torch.as_tensor(pos), torch.as_tensor(val),
                          recs[1], valid=torch.as_tensor(valid))
    _close(out, ref, dict(rtol=1e-5, atol=1e-5))
    assert np.isfinite(out.numpy()).all()
    # each splat deposits its value where its whole footprint is inside
    one = tfilm.splat_add(torch.zeros(h, w, 3), torch.tensor([[8.3, 6.6]]),
                          torch.tensor([[1.0, 2.0, 3.0]]), recs[1])
    np.testing.assert_allclose(one.sum(dim=(0, 1)).numpy(), [1.0, 2.0, 3.0], rtol=1e-5)


def _render_pair(xml, spp):
    ref = np.asarray(mitsuba_tpu.render(jload_string(xml), spp=spp, seed=1))
    out = mt.render(mt.load_scene_string(xml), spp=spp, seed=1, device="cpu")
    return out, ref


@pytest.mark.parametrize("name", ["cbox", "spot", "directional"])
def test_render_matches_reference(name):
    """render_ptracer against the reference's: cbox (area light, maxDepth
    4) and the two-wall scene under a spot and a directional light, 16x16,
    4 particles per pixel."""
    if name == "cbox":
        xml = with_integrator(cbox_ptracer_xml(16, 16), "ptracer", max_depth=4)
    else:
        xml = two_wall_xml(name, "ptracer", max_depth=4, spp=4, width=16, height=16)
    out, ref = _render_pair(xml, 4)
    assert out.shape == ref.shape == (16, 16, 3)
    assert _tm_rmse(out, ref) < 5e-3, _tm_rmse(out, ref)
    assert out.mean() > 0


def test_cbox_meets_golden():
    """cbox at 64x64, 16 particles per pixel (one batch of 65,536), its
    maxDepth 16, against tests/golden/torch_cbox_ptracer_64_16.npy."""
    golden = np.load(os.path.join(ROOT, "tests", "golden", "torch_cbox_ptracer_64_16.npy"))
    out = mt.render(mt.load_scene_string(cbox_ptracer_xml(64, 64)), spp=16, seed=0, device="cpu")
    gate = GOLDEN_GATES["torch_cbox_ptracer_64_16.npy"]
    assert _tm_rmse(out, golden) < gate, _tm_rmse(out, golden)
    assert int(tpt.render_ptracer.last_ray_count) > 16 * 64 * 64
