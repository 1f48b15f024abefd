"""The port's sharded render (mitsuba_tpu_torch/parallel/mesh.py) over
gloo ranks on the CPU, against the port's unsharded render and the JAX
package's render_sharded (tests/test_sharding.py's cases).

One spawned world per size renders every case of tests/torch_ranks.py
CASES once (torch.multiprocessing, a file:// store under tmp_path, a 60
s time limit on the rendezvous and the collectives, a join time limit),
and the parametrised tests read what each rank wrote:

* a world of 2: every family (path, volpath in a fog, bdpt, sppm,
  ptracer, vpl, pssmlt, mlt, erpt); a world of 3: the uneven splits (cbox
  at 3 spp: one layer per rank; at 2 spp: the third rank's layers all
  past spp_chunk, its contribution scaled by 0; sppm at 64x64, as
  tests/test_sharding.py renders it: 4,096 pixels and 8,192 photons
  padded to 4,098 and 8,193 lanes);
* every rank returns the same image;
* the path family, bdpt, ptracer and vpl against the port's `render` at
  tests/test_sharding.py's gate (relative RMSE < 1e-4; the fog's 1e-3):
  the counter RNG keys each sample, so only the film's float sums are
  reassociated (measured 3e-8 to 3.8e-6); sppm at its gate (0.05; measured
  6.1e-3 on 2 and 3 ranks: each rank's photon map subsamples its crowded
  cells on its own photons);
* cbox under path against the JAX package's render_sharded on its
  8-device CPU mesh at tests/test_golden.py's gate (tone-mapped RMSE
  < 5e-3) and size (64x64, 16 spp): the packages differ in float32's last
  places, and paths that diverge on one move their pixel whole (ROADMAP
  C, "Known differences"); at 32x32, 8 spp the two sit 6.4e-3 apart,
  as the unsharded renders do;
* pssmlt, mlt and erpt with a mesh against without: each chain keys its
  draws by its global id, so the chains are the same and only the
  films' sums are reassociated; measured largest difference 1.1e-7 to
  8.4e-7 of the image's largest value, gate 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.parallel.mesh import make_mesh, render_sharded, spawn_ranks
from tests.conftest import rel_rmse
from tests.torch_ranks import CASES, SPPM_PHOTONS, sharded_cases

torch.set_num_threads(1)

WORLDS = {
    2: ("path", "path_64", "volpath_fog", "bdpt", "sppm", "ptracer", "vpl", "pssmlt", "mlt", "erpt"),
    3: ("path_3spp", "path_2spp", "sppm"),
}
UNSHARDED_GATE = {"volpath_fog": 1e-3, "sppm": 0.05}
CHAIN_KINDS = ("pssmlt", "mlt", "erpt")
CHAIN_RTOL = 1e-5
JOIN_S = 240.0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: [each rank's {case: image}]}."""
    out = {}
    for world, names in WORLDS.items():
        d = tmp_path_factory.mktemp(f"world{world}")
        spawn_ranks(sharded_cases, world, (f"file://{d}/store", str(d), names), JOIN_S)
        out[world] = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
    return out


def _unsharded(name):
    xml, spp, seed = CASES[name]
    scene = mt.load_scene_string(xml)
    if scene.integrator.kind == "sppm":
        from mitsuba_tpu_torch.integrator.sppm import render_sppm

        return render_sppm(scene, spp=spp, seed=seed, photons_per_pass=SPPM_PHOTONS,
                           device="cpu")
    return mt.render(scene, spp=spp, seed=seed, device="cpu")


CELLS = [(world, name) for world, names in WORLDS.items() for name in names]


@pytest.mark.parametrize("world,name", CELLS, ids=[f"{w}-{n}" for w, n in CELLS])
def test_every_rank_gets_the_image(worlds, world, name):
    imgs = [r[name] for r in worlds[world]]
    assert imgs[0].shape == _shape(name) and np.isfinite(imgs[0]).all()
    assert imgs[0].mean() > 0.01
    for img in imgs[1:]:
        np.testing.assert_array_equal(img, imgs[0])


def _shape(name):
    scene = mt.load_scene_string(CASES[name][0])
    return (scene.sensor.record.film.height, scene.sensor.record.film.width, 3)


SINGLE = [(w, n) for w, n in CELLS if n not in CHAIN_KINDS]


@pytest.mark.parametrize("world,name", SINGLE, ids=[f"{w}-{n}" for w, n in SINGLE])
def test_sharded_matches_unsharded_render(worlds, world, name):
    assert rel_rmse(worlds[world][0][name], _unsharded(name)) < UNSHARDED_GATE.get(name, 1e-4)


@pytest.mark.parametrize("name", CHAIN_KINDS)
def test_chains_with_mesh_match_without(worlds, name):
    from mitsuba_tpu_torch.integrator.mlt import render_erpt, render_mlt
    from mitsuba_tpu_torch.integrator.pssmlt import render_pssmlt

    xml, spp, seed = CASES[name]
    fn = {"pssmlt": render_pssmlt, "mlt": render_mlt, "erpt": render_erpt}[name]
    ref = fn(mt.load_scene_string(xml), spp=spp, seed=seed, device="cpu")
    got = worlds[2][0][name]
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= CHAIN_RTOL * scale


def test_world_of_one_equals_render_bit_for_bit():
    """Without a process group the mesh is a world of one; at one sample
    layer a pass both renders keep one lane per pixel and add the same
    floats."""
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    xml, spp, seed = CASES["path"]
    scene = mt.load_scene_string(xml)
    n_px = scene.sensor.record.film.width * scene.sensor.record.film.height
    img = render_sharded(scene, mesh=mesh, spp=spp, seed=seed, spp_chunk=1)
    ref = mt.render(scene, spp=spp, seed=seed, device="cpu", lanes_per_pass=n_px)
    np.testing.assert_array_equal(img, ref)
    assert render_sharded.last_ray_count == mt.render.last_ray_count


def test_make_mesh_is_explicit():
    with pytest.raises(ValueError):
        make_mesh(device="cpu", backend="gloo")  # no group to run gloo
    with pytest.raises(RuntimeError):
        make_mesh()  # the card, and this machine has none


def test_path_matches_jax_render_sharded(worlds):
    import jax

    from mitsuba_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mitsuba_tpu.parallel.mesh import render_sharded as jrender_sharded
    from mitsuba_tpu.scene.xml_loader import load_scene_string as jload

    assert len(jax.devices()) == 8
    xml, spp, seed = CASES["path_64"]
    ref = np.asarray(jrender_sharded(jload(xml), mesh=jmake_mesh(), spp=spp, seed=seed))

    def tone(x):
        return np.clip(x, 0, 1) ** (1 / 2.2)

    assert np.sqrt(np.mean((tone(worlds[2][0]["path_64"]) - tone(ref)) ** 2)) < 5e-3
