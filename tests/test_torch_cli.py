"""The port's front doors on the CPU against the JAX package's: the CLI
(mitsuba_tpu_torch/cli.py: -o, -D, -s, --seed, -x, -q, --size,
--pack-cache, --cpu), the tools (tools.py: tonemap, addimages, joinrgb,
kdbench, rdielprec, cylclip and cyl_clip_aabb) and the preview
(preview.py: CameraRig, progressive_render, the HTTP endpoint on
127.0.0.1).  Renders are held at the cbox gate (tone-mapped RMSE < 5e-3,
tests/test_golden.py); files the two packages write from equal inputs
are held byte for byte; without a card and without --cpu the port's entry
points stop instead of rendering on the CPU."""

import json
import math
import os
import urllib.request

import numpy as np
import pytest
import torch

import mitsuba_tpu
from mitsuba_tpu import cli as jcli
from mitsuba_tpu import preview as jpreview
from mitsuba_tpu import tools as jtools
from mitsuba_tpu.io import images as jimages
from mitsuba_tpu_torch import cli, preview, tools
from mitsuba_tpu_torch.io import images
from mitsuba_tpu_torch.renderer import render
from mitsuba_tpu_torch.scene.xml_loader import load_scene
from tests.torch_meshes import ROOT, tm_rmse

torch.set_num_threads(1)

CBOX = os.path.join(ROOT, "scenes", "cbox.xml")
GATE = 5e-3
NO_CARD = not torch.cuda.is_available()


def _scene_copy(tmp_path, name="cbox.xml", width="512", height="512"):
    """scenes/cbox.xml in tmp_path (--pack-cache writes beside the XML), at
    the film size given (text: a number or a $parameter)."""
    xml = open(CBOX).read()
    xml = xml.replace('name="width" value="512"', f'name="width" value="{width}"')
    xml = xml.replace('name="height" value="512"', f'name="height" value="{height}"')
    path = tmp_path / name
    path.write_text(xml)
    return str(path)


def _read(path):
    return images.read_image(path)[0]


def test_cli_renders_as_the_reference(tmp_path, capsys):
    scene = _scene_copy(tmp_path)
    ours, ref = str(tmp_path / "p.exr"), str(tmp_path / "r.exr")
    assert cli.main([scene, "--cpu", "--size", "16x16", "-s", "4", "--seed", "2", "-o", ours]) == 0
    out = capsys.readouterr().out
    assert "* rendering" in out and "16x16 @ 4spp (path)" in out and "Msamples/s" in out
    assert jcli.main([scene, "--cpu", "--size", "16x16", "-s", "4", "--seed", "2", "-o", ref]) == 0
    a, b = _read(ours), _read(ref)
    assert a.shape == b.shape == (16, 16, 3)
    assert tm_rmse(a, b) < GATE
    # the file holds render's image at half precision
    s = load_scene(scene)
    s.sensor.record.film.width = s.sensor.record.film.height = 16
    np.testing.assert_array_equal(
        a, render(s, spp=4, seed=2, device="cpu").astype(np.float16).astype(np.float32))


def test_cli_defines_skip_and_quiet(tmp_path, capsys):
    """-D fills the scene's $parameters; -x skips a scene whose output
    exists; -q prints nothing; the output defaults to the XML's name with
    the film's extension."""
    scene = _scene_copy(tmp_path, "param.xml", "$w", "$h")
    args = [scene, "--cpu", "-D", "w=12", "-D", "h=8", "-s", "2"]
    assert cli.main(args + ["-q"]) == 0
    assert capsys.readouterr().out == ""
    out = str(tmp_path / "param.exr")
    img = _read(out)
    assert img.shape == (8, 12, 3)
    jout = str(tmp_path / "jparam.exr")
    jcli.main(args + ["-q", "-o", jout])
    assert tm_rmse(img, _read(jout)) < GATE
    mtime = os.path.getmtime(out)
    assert cli.main(args + ["-x"]) == 0
    assert "skipping" in capsys.readouterr().out
    assert os.path.getmtime(out) == mtime
    with pytest.raises(SystemExit, match="key=value"):
        cli.main([scene, "--cpu", "-D", "w"])


def test_cli_pack_cache(tmp_path, capsys):
    """--pack-cache writes <scene>.mtspack beside the XML, then loads it;
    the JAX package's CLI loads the port's cache too."""
    scene = _scene_copy(tmp_path, width="16", height="16")
    first, second, ref = (str(tmp_path / f"{n}.exr") for n in ("a", "b", "r"))
    assert cli.main([scene, "--cpu", "-s", "2", "--pack-cache", "-o", first]) == 0
    assert "pack cached" in capsys.readouterr().out
    cache = str(tmp_path / "cbox.mtspack")
    assert os.path.exists(cache)
    assert cli.main([scene, "--cpu", "-s", "2", "--pack-cache", "-o", second]) == 0
    assert "pack cache hit" in capsys.readouterr().out
    np.testing.assert_array_equal(_read(first), _read(second))
    assert jcli.main([scene, "--cpu", "-s", "2", "--pack-cache", "-o", ref]) == 0
    assert "pack cache hit" in capsys.readouterr().out
    assert tm_rmse(_read(first), _read(ref)) < GATE
    assert cli.main([scene, "--cpu", "--size", "8x8", "-s", "1", "--pack-cache", "-o", first]) == 0
    assert "pack cache skipped" in capsys.readouterr().out


@pytest.mark.skipif(not NO_CARD, reason="checks the behaviour without a card")
def test_entry_points_stop_without_a_card(tmp_path):
    """Without a card and without --cpu nothing falls back to the CPU."""
    scene = _scene_copy(tmp_path, width="8", height="8")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main([scene, "-s", "1"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tools.main(["kdbench", scene, "-n", "16"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        preview.main([scene, "--max-spp", "1"])
    assert not os.path.exists(str(tmp_path / "cbox.exr"))


# ---- tools ----

def test_tonemap_addimages_joinrgb(tmp_path, capsys):
    rng = np.random.default_rng(0)
    a = np.exp(rng.uniform(-5, 3, (9, 13, 3))).astype(np.float32)
    b = np.exp(rng.uniform(-5, 3, (9, 13, 3))).astype(np.float32)
    pa, pb = str(tmp_path / "a.exr"), str(tmp_path / "b.pfm")
    images.write_image(pa, a)
    images.write_image(pb, b)
    for args in (["tonemap", pa, "-o", "{}.png"],
                 ["tonemap", pa, "-t", "reinhard", "-k", "0.3", "-m", "2", "-o", "{}.png"],
                 ["tonemap", pb, "-g", "2.2", "-o", "{}.png"],
                 ["addimages", "0.5", pa, "2", pb, "{}.pfm"],
                 ["joinrgb", pa, pb, pa, "{}.exr"]):
        ours = [x.format(str(tmp_path / "ours")) for x in args]
        ref = [x.format(str(tmp_path / "ref")) for x in args]
        assert tools.main(ours) == 0
        assert jtools.main(ref) == 0
        assert open(ours[-1], "rb").read() == open(ref[-1], "rb").read(), args
    assert capsys.readouterr().out.count("wrote") == 4


def test_tools_usage(capsys):
    assert tools.main([]) == jtools.main([]) == 1
    assert "kdbench" in capsys.readouterr().err


def test_kdbench_on_the_cpu(tmp_path, capsys):
    scene = _scene_copy(tmp_path, width="8", height="8")
    tools.main(["kdbench", scene, "--cpu", "-n", "4096", "--best-of", "1"])
    tools.main(["kdbench", scene, "--cpu", "-n", "4096", "--best-of", "1", "--coherent"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "MRays/s (36 tris, brute, incoherent, best of 1) on the CPU" in lines[0]
    assert "(36 tris, brute, coherent, best of 1) on the CPU" in lines[2]
    assert lines[1] == lines[3] == "kdbench: launches {}"  # plain versions on the CPU


def test_rdielprec_and_cylclip(tmp_path, capsys):
    args = ["rdielprec", "--n-alpha", "3", "--n-cos", "4", "--samples", "256", "-o"]
    tools.main(args + [str(tmp_path / "p.npz")])
    jtools.main(args + [str(tmp_path / "r.npz")])
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "r.npz") as r:
        assert sorted(p.files) == sorted(r.files)
        assert str(p["dist"]) == str(r["dist"]) == "ggx"
        for k in ("alphas", "cosines", "T", "eta"):
            np.testing.assert_allclose(p[k], r[k], rtol=1e-6, atol=1e-7, err_msg=k)
    capsys.readouterr()
    assert tools.cylclip(["--trials", "60", "--seed", "3"]) == jtools.cylclip(
        ["--trials", "60", "--seed", "3"]) == 0
    ours, ref = capsys.readouterr().out.strip().splitlines()
    assert ours == ref
    rng = np.random.default_rng(1)
    for _ in range(50):
        p0, p1 = rng.uniform(-1, 1, 3), rng.uniform(-1, 1, 3)
        blo = rng.uniform(-0.8, 0, 3)
        bhi = blo + rng.uniform(0, 1.6, 3)
        rad = rng.uniform(0.01, 0.5)
        for x, y in zip(tools.cyl_clip_aabb(p0, p1, rad, blo, bhi),
                        jtools.cyl_clip_aabb(p0, p1, rad, blo, bhi)):
            np.testing.assert_array_equal(x, y)


# ---- preview ----

def test_camera_rig_equal():
    tw = load_scene(CBOX).sensor.record.to_world
    ours = preview.CameraRig(tw, dist=2.0)
    ref = jpreview.CameraRig(mitsuba_tpu.load_scene(CBOX).sensor.record.to_world, dist=2.0)
    for verb, args in (("to_transform", ()), ("orbit", (0.5, 0.1)), ("dolly", (0.5,)),
                       ("pan", (0.1, -0.2)), ("orbit", (-1.0, 3.0)), ("reset", ())):
        getattr(ours, verb)(*args)
        getattr(ref, verb)(*args)
        np.testing.assert_array_equal(ours.to_transform().m, np.asarray(ref.to_transform().m))
        np.testing.assert_array_equal(ours.to_transform().inv,
                                      np.asarray(ref.to_transform().inv))
        assert (ours.az, ours.el, ours.dist) == (ref.az, ref.el, ref.dist)


def test_progressive_render_passes():
    """Each pass is render(spp=spp_chunk, seed=pass index), and the running
    average is the reference's (within the cbox gate); a camera move
    restarts the accumulation."""
    camera, jcamera = {"rig": None, "version": 0}, {"rig": None, "version": 0}
    gen = preview.progressive_render(CBOX, spp_chunk=2, max_spp=0, camera=camera, film_res=16,
                                     device="cpu")
    jgen = jpreview.progressive_render(CBOX, spp_chunk=2, max_spp=0, camera=jcamera,
                                       film_res=16)
    s = load_scene(CBOX)
    s.sensor.record.film.width = s.sensor.record.film.height = 16
    passes = [render(s, spp=2, seed=i, device="cpu") for i in range(2)]
    for i in range(2):
        (acc, total, _), (jacc, jtotal, _) = next(gen), next(jgen)
        assert total == jtotal == 2 * (i + 1)
        np.testing.assert_allclose(acc, np.mean(passes[:i + 1], axis=0), rtol=1e-6, atol=1e-7)
        assert tm_rmse(acc, np.asarray(jacc)) < GATE
    for cam in (camera, jcamera):
        cam["rig"].orbit(0.6, 0.0)
        cam["version"] += 1
    (acc, total, _), (jacc, jtotal, _) = next(gen), next(jgen)
    assert total == jtotal == 2
    assert float(np.abs(acc - passes[0]).max()) > 1e-3
    assert tm_rmse(acc, np.asarray(jacc)) < GATE
    gen.close()
    jgen.close()


def test_progressive_render_orchestrated(tmp_path):
    """An integrator with its own orchestration (ptracer) goes through
    render: a pass is render(spp=spp_chunk, seed=pass index)."""
    path = tmp_path / "ptracer.xml"
    path.write_text(open(CBOX).read().replace('<integrator type="path">',
                                              '<integrator type="ptracer">'))
    gen = preview.progressive_render(str(path), spp_chunk=1, max_spp=1, film_res=8,
                                     device="cpu")
    acc, total, _ = next(gen)
    s = load_scene(str(path))
    s.sensor.record.film.width = s.sensor.record.film.height = 8
    assert s.integrator.kind == "ptracer" and total == 1
    np.testing.assert_array_equal(acc, render(s, spp=1, seed=0, device="cpu"))


def test_http_endpoint(tmp_path):
    rig = preview.CameraRig(load_scene(CBOX).sensor.record.to_world, dist=2.0)
    camera = {"rig": rig, "version": 0}
    state = {"scene": "cbox.xml", "camera": camera, "spp": 7, "dt": 0.5}
    httpd = preview._serve(state, 0)
    port = httpd.server_address[1]
    try:
        az0, dist0 = rig.az, rig.dist
        url = (f"http://127.0.0.1:{port}/cam?daz=0.25&del=0.0"
               f"&logd={math.log(0.5)}&px=0.01&py=0.0")
        assert urllib.request.urlopen(url, timeout=10).status == 200
        assert camera["version"] == 1
        assert math.isclose(rig.az, az0 + 0.25, rel_tol=1e-9)
        assert math.isclose(rig.dist, dist0 * 0.5, rel_tol=1e-6)
        s = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/state", timeout=10).read())
        assert s == {"scene": "cbox.xml", "spp": 7, "dt": 0.5}
        urllib.request.urlopen(f"http://127.0.0.1:{port}/cam?reset=1", timeout=10)
        assert camera["version"] == 2 and math.isclose(rig.az, az0, rel_tol=1e-9)
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read().decode()
        assert "pointerdown" in page and "mitsuba_tpu_torch preview" in page
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/img", timeout=10)
        png = str(tmp_path / "p.png")
        images.write_image(png, np.full((4, 4, 3), 0.5, np.float32))
        state["png"] = open(png, "rb").read()
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/img", timeout=10).read()
        assert body == state["png"]
        jimages.write_image(str(tmp_path / "r.png"), np.full((4, 4, 3), 0.5, np.float32))
        assert body == open(tmp_path / "r.png", "rb").read()
    finally:
        httpd.shutdown()
