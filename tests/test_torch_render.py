"""The port's whole slice on the CPU: `load_scene` -> `render` of the
Cornell box against the reference's golden image, at the gate of
tests/test_golden.py (tone-mapped RMSE < 5e-3)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.integrator import path as jpath
from mitsuba_tpu_torch.film.film import new_film
from mitsuba_tpu_torch.integrator import path as tpath
from mitsuba_tpu_torch.renderer import make_render_pass
from mitsuba_tpu_torch.scene.builder import pack_scene

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CBOX = os.path.join(ROOT, "scenes", "cbox.xml")


def _tonemapped_rmse(img, ref):
    a = img / (1.0 + img)
    b = ref / (1.0 + ref)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _cbox(size):
    scene = mt.load_scene(CBOX)
    scene.sensor.record.film.width = scene.sensor.record.film.height = size
    return scene


def test_cbox_matches_golden():
    golden = np.load(os.path.join(ROOT, "tests", "golden", "cbox_64_16.npy"))
    img = mt.render(_cbox(64), spp=16, seed=0, device="cpu")
    assert img.shape == golden.shape and img.dtype == np.float32
    assert np.isfinite(img).all()
    assert _tonemapped_rmse(img, golden) < 5e-3


def test_render_pass_gives_every_pixel_its_samples():
    """Regeneration: each pixel receives exactly spp samples, and the
    ray count covers at least one closest-hit ray per sample."""
    scene = _cbox(8)
    rec = scene.sensor.record
    pack = pack_scene(scene, "cpu")
    for spp_chunk in (1, 4):
        rp = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler,
                              spp_chunk, "cpu")
        film, n_rays = rp(new_film(8, 8, "cpu"), 0, 0)
        assert torch.equal(film[..., 3], torch.full((8, 8), float(spp_chunk)))
        assert int(n_rays) >= 64 * spp_chunk
        assert torch.isfinite(film).all()


def test_render_is_deterministic_and_seeded():
    scene = _cbox(8)
    a = mt.render(scene, spp=2, seed=0, device="cpu")
    b = mt.render(scene, spp=2, seed=0, device="cpu")
    c = mt.render(scene, spp=2, seed=1, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_mi_weight_matches_reference():
    r = np.random.default_rng(0)
    a = r.uniform(0, 5, 1000).astype(np.float32)
    b = r.uniform(0, 5, 1000).astype(np.float32)
    a[:10] = 0.0
    b[:5] = 0.0
    np.testing.assert_allclose(
        tpath.mi_weight(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jpath.mi_weight(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("option", ["strict_normals", "hide_emitters"])
def test_unported_integrator_options_raise(option):
    scene = _cbox(8)
    setattr(scene.integrator, option, True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        mt.render(scene, spp=1, device="cpu")


def test_render_from_reference_pack_is_identical():
    """The slice renders a converted reference pack bit for bit like the
    port's own pack of the same scene."""
    from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
    from mitsuba_tpu.scene.xml_loader import load_scene as jload
    from mitsuba_tpu_torch.scene.builder import pack_from_numpy

    jp = jpack_scene(jload(CBOX))
    converted = pack_from_numpy(
        {k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu"
    )
    scene = _cbox(16)
    a = mt.render(scene, spp=4, seed=3, device="cpu")
    b = mt.render(scene, spp=4, seed=3, device="cpu", pack=converted)
    np.testing.assert_array_equal(a, b)
