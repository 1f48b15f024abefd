"""The port's films (mitsuba_tpu_torch/film/plugins.py) against the JAX
package's: `develop_to_array` (exposure, the sRGB curve or 1/gamma,
Reinhard with its key and burn) within 1e-6 on the same numpy-seeded
image, `output_extension` for every film and format, and the films'
records parsed from the same XML (hdrfilm, tiledhdrfilm, ldrfilm, mfilm)
equal field for field.  The reference's own faults the port keeps
(ROADMAP C8) are pinned here: the crop, the pixel and component formats,
banner and highQualityEdges are parsed and never applied, and mfilm's
digits and variable never reach its writer."""

import dataclasses
import os

import numpy as np
import pytest

from mitsuba_tpu.film.plugins import FilmRecord as JFilmRecord
from mitsuba_tpu.io import images as jimages
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.film.plugins import FilmRecord
from mitsuba_tpu_torch.io import images
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string


def _image(seed=0, shape=(16, 24, 3)):
    """Linear HDR values over five decades, with a black pixel."""
    img = np.exp(np.random.default_rng(seed).uniform(-7.0, 4.0, shape)).astype(np.float32)
    img[0, 0] = 0.0
    return img


DEVELOP = [
    dict(),  # hdrfilm: the image itself
    dict(is_ldr=True),  # the sRGB curve
    dict(is_ldr=True, gamma=2.2),
    dict(is_ldr=True, gamma=1.0, exposure=-1.5),
    dict(is_ldr=True, tonemap="reinhard"),
    dict(is_ldr=True, tonemap="reinhard", key=0.36, burn=0.4, exposure=0.5),
    dict(is_ldr=True, tonemap="reinhard", burn=1.0, gamma=2.0),
]


@pytest.mark.parametrize("kw", DEVELOP, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items())
                         or "hdr")
def test_develop_to_array(kw):
    img = _image(seed=len(kw))
    ours = FilmRecord(**kw).develop_to_array(img)
    ref = np.asarray(JFilmRecord(**kw).develop_to_array(img))
    assert ours.shape == ref.shape == img.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    if kw.get("is_ldr"):
        assert ours.min() >= 0.0 and ours.max() <= 1.0


FILMS = [
    ('<film type="hdrfilm"/>', ".exr"),
    ('<film type="hdrfilm"><string name="fileFormat" value="openexr"/></film>', ".exr"),
    ('<film type="hdrfilm"><string name="fileFormat" value="RGBE"/></film>', ".hdr"),
    ('<film type="hdrfilm"><string name="fileFormat" value="pfm"/></film>', ".pfm"),
    ('<film type="hdrfilm"><string name="fileFormat" value="tga"/></film>', ".exr"),
    ('<film type="tiledhdrfilm"/>', ".exr"),
    ('<film type="ldrfilm"/>', ".png"),
    ('<film type="ldrfilm"><string name="fileFormat" value="jpeg"/></film>', ".png"),
    ('<film type="mfilm"/>', ".m"),
    ('<film type="mfilm"><string name="fileFormat" value="numpy"/></film>', ".npy"),
]


def _xml(film):
    return f'<scene version="0.5.0"><sensor type="perspective">{film}</sensor></scene>'


@pytest.mark.parametrize("film,ext", FILMS)
def test_output_extension(film, ext):
    ours = load_scene_string(_xml(film)).sensor.record.film
    ref = jload_string(_xml(film)).sensor.record.film
    assert ours.output_extension() == ref.output_extension() == ext


# every property the reference's films parse, away from its defaults
PROPS = """
  <integer name="width" value="40"/><integer name="height" value="30"/>
  <integer name="cropOffsetX" value="3"/><integer name="cropOffsetY" value="5"/>
  <integer name="cropWidth" value="20"/><integer name="cropHeight" value="10"/>
  <string name="pixelFormat" value="RGBA"/><string name="componentFormat" value="float32"/>
  <boolean name="banner" value="true"/><boolean name="highQualityEdges" value="true"/>
  <rfilter type="mitchell"><float name="B" value="0.5"/><float name="C" value="0.25"/></rfilter>
"""
LDR = """
  <string name="tonemapMethod" value="reinhard"/><float name="gamma" value="1.8"/>
  <float name="exposure" value="-0.5"/><float name="key" value="0.3"/>
  <float name="burn" value="0.2"/>
"""
MFILM = '<integer name="digits" value="7"/><string name="variable" value="meter"/>'


@pytest.mark.parametrize("film", [
    f'<film type="hdrfilm">{PROPS}<string name="fileFormat" value="pfm"/></film>',
    f'<film type="tiledhdrfilm">{PROPS}</film>',
    f'<film type="ldrfilm">{PROPS}{LDR}</film>',
    f'<film type="mfilm">{PROPS}{MFILM}</film>',
    f'<film type="mfilm">{MFILM}<string name="fileFormat" value="numpy"/></film>',
    '<film type="ldrfilm"/>',
    '<film type="mfilm"/>',
], ids=["hdrfilm", "tiledhdrfilm", "ldrfilm", "mfilm", "mfilm-defaults-numpy", "ldr-defaults",
        "mfilm-defaults"])
def test_films_parse_as_the_reference(film):
    ours = load_scene_string(_xml(film)).sensor.record.film
    ref = jload_string(_xml(film)).sensor.record.film
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    if "mfilm" in film and "width" not in film:
        # measurement films default to 1x1 and a box filter
        assert (ours.width, ours.height, ours.rfilter.kind, ours.rfilter.radius) == (1, 1, 0, 0.5)


def test_c8_crop_and_formats_are_parsed_and_not_applied(tmp_path):
    """ROADMAP C8: the crop window is parsed and never applied (the film
    renders width x height), componentFormat float32 still writes half
    EXR channels, and pixelFormat rgba still writes three channels."""
    from mitsuba_tpu_torch.io.exr import read_exr

    film = load_scene_string(_xml(f'<film type="hdrfilm">{PROPS}</film>')).sensor.record.film
    assert film.crop_size == (20, 10) and film.crop_offset == (3, 5)
    img = film.develop_to_array(_image(shape=(film.height, film.width, 3)))
    assert img.shape == (30, 40, 3)  # not the crop
    path = str(tmp_path / "a.exr")
    images.write_image(path, img)
    data = open(path, "rb").read()
    chlist = data[data.index(b"chlist\x00") + 11:]
    assert chlist[2:6] == (1).to_bytes(4, "little")  # HALF, not FLOAT
    back, names = read_exr(path)
    assert names == ["R", "G", "B"]
    np.testing.assert_array_equal(back, img.astype(np.float16))


def test_c8_mfilm_digits_and_variable_do_not_reach_the_writer(tmp_path):
    """ROADMAP C8: mfilm's digits (7 here) and variable ("meter") do not
    reach the .m writer, which names its matrix `data` and writes %.8g, in
    both packages alike."""
    film = load_scene_string(_xml(f'<film type="mfilm">{MFILM}</film>')).sensor.record.film
    assert (film.digits, film.variable) == (7, "meter")
    img = np.full((1, 1, 1), 1.0 / 3.0, np.float32)
    ours, ref = str(tmp_path / "p.m"), str(tmp_path / "r.m")
    images.write_image(ours, film.develop_to_array(img))
    jimages.write_image(ref, img)
    text = open(ours).read()
    assert text == open(ref).read() == "data = [0.33333334];\n"
    assert os.path.getsize(ours) > 0
