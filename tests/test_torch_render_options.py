"""`render`'s options in the port (mitsuba_tpu_torch/renderer.py) against
the JAX package's, on the CPU at 16x16 to 32x32: checkpoint and resume
(bit-identical, the port's tests/test_aux.py:35), `lanes_per_pass` and
MTS_TPU_LANES_PER_PASS, `progress`, `return_film` (the weighted film, and
the ones-alpha film of the integrators without one), the out-of-core
`tiledhdrfilm` (a host memory-map within 1e-4 of hdrfilm, and within the
cbox gate of the reference's tiled render), `render_to_file` through
ldrfilm (the PNG within one 8-bit level of the reference's develop and
writer on the same image, the image within the cbox gate of the
reference's render) and mfilm (.m text equal), and the logger's "Samples rendered"
counter."""

import copy
import os

import numpy as np
import pytest
import torch

import mitsuba_tpu
import mitsuba_tpu_torch as mt
from mitsuba_tpu.core import logging as jlogging
from mitsuba_tpu.io import images as jimages
from mitsuba_tpu.film.plugins import MITCHELL as JMITCHELL
from mitsuba_tpu.film.plugins import RFilterRecord as JRFilterRecord
from mitsuba_tpu.io.images import read_image as jread_image
from mitsuba_tpu.renderer import render_to_file as jrender_to_file
from mitsuba_tpu_torch.core import logging as tlogging
from mitsuba_tpu_torch.film.film import develop
from mitsuba_tpu_torch.film.plugins import MITCHELL, RFilterRecord
from mitsuba_tpu_torch.io.images import read_image
from mitsuba_tpu_torch.renderer import band_plan, render, render_to_file
from tests.torch_meshes import METERS, ROOT, meter_xml, tm_rmse

torch.set_num_threads(1)

CBOX = os.path.join(ROOT, "scenes", "cbox.xml")
GATE = 5e-3  # tests/test_golden.py's cbox gate


def _cbox(size=16, load=mt.load_scene):
    scene = load(CBOX)
    scene.sensor.record.film.width = scene.sensor.record.film.height = size
    return scene


class Stop(Exception):
    pass


def test_checkpoint_resume_bit_identical(tmp_path):
    """A checkpointed render stopped halfway (through `progress`) resumes
    to the uninterrupted render's image, bit for bit."""
    scene = _cbox()
    ref = render(scene, spp=8, lanes_per_pass=16 * 16 * 2, device="cpu")  # 4 passes
    ck = str(tmp_path / "film.npz")
    calls = []

    def interrupt(i, n):
        calls.append((i, n))
        if i == 2:
            raise Stop

    with pytest.raises(Stop):
        render(scene, spp=8, lanes_per_pass=16 * 16 * 2, checkpoint=ck, checkpoint_every=1,
               progress=interrupt, device="cpu")
    assert calls == [(1, 4), (2, 4)]
    with np.load(ck) as z:
        assert (int(z["passes_done"]), int(z["spp_chunk"]), z["film"].shape) == (2, 2, (16, 16, 4))
    resumed = render(scene, spp=8, lanes_per_pass=16 * 16 * 2, checkpoint=ck,
                     checkpoint_every=1, device="cpu")
    np.testing.assert_array_equal(resumed, ref)
    # a checkpoint of another pass size is not resumed from
    other = render(scene, spp=8, lanes_per_pass=16 * 16 * 4, checkpoint=ck, device="cpu")
    with np.load(ck) as z:
        assert (int(z["passes_done"]), int(z["spp_chunk"])) == (2, 4)
    np.testing.assert_allclose(other, ref, rtol=1e-5, atol=1e-6)


def test_checkpoint_file_matches_the_reference(tmp_path):
    """The checkpoint holds the reference's keys, shapes and counts, and
    its film lies within the cbox gate of the reference's."""
    ours, ref = str(tmp_path / "p.npz"), str(tmp_path / "r.npz")
    render(_cbox(), spp=8, lanes_per_pass=512, checkpoint=ours, checkpoint_every=3,
           device="cpu")
    mitsuba_tpu.render(_cbox(load=mitsuba_tpu.load_scene), spp=8, lanes_per_pass=512,
                       checkpoint=ref, checkpoint_every=3)
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files) == ["film", "passes_done", "spp_chunk"]
        assert int(a["passes_done"]) == int(b["passes_done"]) == 4
        assert int(a["spp_chunk"]) == int(b["spp_chunk"]) == 2
        np.testing.assert_array_equal(a["film"][..., 3], b["film"][..., 3])
        assert tm_rmse(a["film"][..., :3] / 8, b["film"][..., :3] / 8) < GATE


@pytest.mark.parametrize("lanes", [256, 512, 16 * 16 * 8])
def test_lanes_per_pass(lanes, monkeypatch):
    """The lanes of a pass change the passes and the order of the film's
    float sums, not the samples (where the samples per pass divide spp;
    else the last pass renders past spp, as the reference's does): the
    images agree to float rounding, and the variable gives what the
    argument gives."""
    scene = _cbox()
    ref = render(scene, spp=8, seed=3, device="cpu")
    img = render(scene, spp=8, seed=3, lanes_per_pass=lanes, device="cpu")
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)
    monkeypatch.setenv("MTS_TPU_LANES_PER_PASS", str(lanes))
    np.testing.assert_array_equal(render(scene, spp=8, seed=3, device="cpu"), img)
    seen = []
    render(scene, spp=8, seed=3, device="cpu", progress=lambda i, n: seen.append((i, n)))
    n = -(-8 // max(1, min(8, lanes // 256)))
    assert seen == [(i + 1, n) for i in range(n)]


def test_lanes_per_pass_against_the_reference():
    """At the same lanes per pass the two packages render within the cbox
    gate (the batched splat under mitchell, 3 passes of 2 spp)."""
    scene, jscene = _cbox(), _cbox(load=mitsuba_tpu.load_scene)
    scene.sensor.record.film.rfilter = RFilterRecord(MITCHELL, 2.0)
    jscene.sensor.record.film.rfilter = JRFilterRecord(JMITCHELL, 2.0)
    ours = render(scene, spp=6, seed=1, lanes_per_pass=512, device="cpu")
    ref = mitsuba_tpu.render(jscene, spp=6, seed=1, lanes_per_pass=512)
    assert tm_rmse(ours, ref) < GATE


def test_return_film_matches_the_reference():
    scene, jscene = _cbox(), _cbox(load=mitsuba_tpu.load_scene)
    img, film = render(scene, spp=8, seed=0, return_film=True, device="cpu")
    jimg, jfilm = mitsuba_tpu.render(jscene, spp=8, seed=0, return_film=True)
    assert torch.is_tensor(film) and film.device.type == "cpu" and film.dtype == torch.float32
    assert tuple(film.shape) == tuple(np.asarray(jfilm).shape) == (16, 16, 4)
    np.testing.assert_array_equal(develop(film).numpy(), img)
    # the regenerating wavefront's weights are the samples each pixel took
    np.testing.assert_array_equal(film[..., 3].numpy(), np.asarray(jfilm)[..., 3])
    assert tm_rmse(img, jimg) < GATE


@pytest.mark.parametrize("kind", ["multichannel", "spectral", "orchestrated"])
def test_return_film_ones_alpha(kind):
    """Integrators without a weighted film return the image's first three
    channels with an alpha of ones, as the reference builds it."""
    scene = _cbox(8)
    kw = {}
    if kind == "multichannel":
        from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord

        scene.integrator = IntegratorRecord(kind="multichannel", sub_integrators=[
            IntegratorRecord(kind="direct"), IntegratorRecord(kind="ao")])
    elif kind == "spectral":
        kw = dict(spectral_bins=6)
    else:
        from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord

        scene.integrator = IntegratorRecord(kind="ptracer", max_depth=3)
    img, film = render(scene, spp=2, seed=0, return_film=True, device="cpu", **kw)
    assert tuple(film.shape) == (8, 8, 4)
    np.testing.assert_array_equal(film[..., :3].numpy(), img[..., :3].astype(np.float32))
    np.testing.assert_array_equal(film[..., 3].numpy(), np.ones((8, 8), np.float32))


def test_tiledhdrfilm(tmp_path):
    """The out-of-core film in row bands (3 bands at 16 x 32 lanes) through
    the batched splat, a host memory-map within 1e-4 of hdrfilm under the
    same (mitchell) filter and within the cbox gate of the reference's
    tiled render; under a gaussian filter it still takes the splat, as
    the reference's does."""
    scene = _cbox(32)
    scene.sensor.record.film.rfilter = RFilterRecord(MITCHELL, 2.0)
    ref = render(scene, spp=4, seed=7, device="cpu")
    tiled = copy.deepcopy(scene)
    tiled.sensor.record.film.out_of_core = True
    seen = []
    img, film = render(tiled, spp=4, seed=7, lanes_per_pass=16 * 32, device="cpu",
                       return_film=True, progress=lambda i, n: seen.append((i, n)))
    hb, pad, n_bands, chunk, passes = band_plan(tiled.sensor.record.film, 4, 16 * 32)
    assert (hb, pad, n_bands, chunk, passes) == (12, 2, 3, 1, 4)
    assert seen == [(i + 1, 12) for i in range(12)]
    assert isinstance(img, np.memmap) and isinstance(film, np.memmap)
    assert img.shape == (32, 32, 3) and film.shape == (32, 32, 4)
    np.testing.assert_allclose(np.asarray(img), ref, rtol=1e-4, atol=1e-4)
    jscene = _cbox(32, load=mitsuba_tpu.load_scene)
    jscene.sensor.record.film.rfilter = JRFilterRecord(JMITCHELL, 2.0)
    jscene.sensor.record.film.out_of_core = True
    jimg = mitsuba_tpu.render(jscene, spp=4, seed=7)
    assert tm_rmse(np.asarray(img), np.asarray(jimg)) < GATE
    # gaussian: the banded splat (not the regenerating wavefront), whole
    # frame or banded the same estimator
    g = _cbox(32)
    g.sensor.record.film.out_of_core = True
    g_img = render(g, spp=4, seed=7, device="cpu")
    g_banded = render(g, spp=4, seed=7, lanes_per_pass=16 * 32, device="cpu")
    np.testing.assert_allclose(np.asarray(g_img), np.asarray(g_banded), rtol=1e-4, atol=1e-4)
    assert float(np.abs(np.asarray(g_img) - render(_cbox(32), spp=4, seed=7,
                                                   device="cpu")).max()) > 1e-3


def test_render_to_file_ldrfilm(tmp_path):
    xml = open(CBOX).read().replace('type="hdrfilm"', 'type="ldrfilm"')
    xml = xml.replace('name="width" value="512"', 'name="width" value="16"').replace(
        'name="height" value="512"', 'name="height" value="16"')
    scene = mt.load_scene_string(xml, base_dir=os.path.dirname(CBOX))
    jscene = mitsuba_tpu.load_scene_string(xml, base_dir=os.path.dirname(CBOX))
    ours, img = render_to_file(scene, output=str(tmp_path / "p.png"), spp=8, device="cpu")
    ref, _ = jrender_to_file(jscene, output=str(tmp_path / "r.png"), spp=8)
    assert ours.endswith("p.png") and img.max() <= 1.0
    a, a_ldr = read_image(ours)
    b, b_ldr = jread_image(ref)
    assert a_ldr and b_ldr and a.shape == b.shape == (16, 16, 3)
    # the reference's develop and writer on the port's image: within one
    # 8-bit level of the port's file
    hdr = render(scene, spp=8, device="cpu")
    jimages.write_image(str(tmp_path / "same.png"), jscene.sensor.record.film.develop_to_array(hdr))
    assert float(np.abs(a - jread_image(str(tmp_path / "same.png"))[0]).max()) <= 1 / 255 + 1e-7
    # the two renders at the cbox gate (paths diverging on last-place
    # differences move 8 of these pixels by more than a level, one by 17,
    # ROADMAP C)
    assert tm_rmse(hdr, mitsuba_tpu.render(jscene, spp=8)) < GATE


def test_render_to_file_mfilm_default_output(tmp_path):
    """mfilm through render_to_file, to the path beside the scene's XML:
    a radiance meter in a unit constant environment reads exactly 1 in
    both packages, so the .m text is equal."""
    xml = meter_xml(METERS["radiancemeter"][0]).replace('type="hdrfilm"', 'type="mfilm"')
    path = str(tmp_path / "meter.xml")
    open(path, "w").write(xml)
    jpath = str(tmp_path / "jmeter.xml")
    open(jpath, "w").write(xml)
    out, img = render_to_file(mt.load_scene(path), spp=64, seed=3, device="cpu")
    jout, _ = jrender_to_file(mitsuba_tpu.load_scene(jpath), spp=64, seed=3)
    assert out == str(tmp_path / "meter.m") and jout == str(tmp_path / "jmeter.m")
    assert open(out).read() == open(jout).read() == "data_0 = [1];\ndata_1 = [1];\ndata_2 = [1];\n"


def test_samples_counter_and_log(capsys):
    """The pass loop counts "Samples rendered" as the reference's does and
    logs the pass plan at debug level."""
    buf = []

    class Cap(tlogging.Appender):
        def append(self, level, text):
            buf.append((level, text))

    tlogging.logger.add_appender(Cap())
    saved = tlogging.logger.level
    tlogging.logger.level = tlogging.EDebug
    try:
        tlogging.reset_statistics()
        jlogging.reset_statistics()
        render(_cbox(), spp=8, lanes_per_pass=512, device="cpu")
        mitsuba_tpu.render(_cbox(load=mitsuba_tpu.load_scene), spp=8, lanes_per_pass=512)
    finally:
        tlogging.logger.level = saved
        tlogging.logger.appenders.pop()
    assert tlogging.counter("Samples rendered").value == jlogging.counter(
        "Samples rendered").value == 16 * 16 * 8
    assert any("render: 16x16, 8 spp (4 passes x 2), integrator=path" in t for _, t in buf)
