"""The rest of a run on the CPU at a small size, the card's look skipped:
sound runs come out correct, and each fault a cell can have, and the
control (the plain reference in bfloat16 in the program's place), come out
not correct under the committed limits."""

import os
import time
import types

import numpy as np
import pytest
import torch

from portbench import run as harness
from portbench.lib import cells, ranks, scenes
from portbench.reference import pathtrace

BENCH = cells.benchmark()
SEED = 2_200_000_123  # past 2**31: a seed may exceed 32 signed bits
FAULT_ENV = "PORTBENCH_TEST_FAULT"


def small_cell(workload):
    """The cell at a size a test run holds (its limits as committed)."""
    cell = cells.resolve(BENCH, workload)
    tr = dict(cell.traffic)
    tr.update(width=32, height=18, spp=4, check={"pixels": 576, "ref_spp": 128,
                                                 "lanes": 1 << 16})
    if "ranks" in tr:  # half of 8 spp still gives each of 4 ranks a sample
        tr.update(ranks=4, spp=8)
    cell.traffic = tr
    return cell


def execute(cell):
    torch.set_num_threads(2)
    result, _ = harness.execute(cell, SEED, 0.1, 0, "cpu", time.perf_counter())
    return result


# --- renders ---------------------------------------------------------------

def _bf16_image(cell, scene, spp, seed):
    """The control: every pixel rendered by the plain reference in bfloat16."""
    film = scene.sensor.record.film
    ref = scenes.reference_scene(scenes.scene_xml(cell.config), film.width, film.height)
    tracer = pathtrace.Tracer(ref, "cpu", torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    s, _, _ = pathtrace.render_pixels(tracer, torch.arange(film.width * film.height), spp, gen)
    return (s / spp).float().reshape(film.height, film.width, 3).numpy()


def render_fault(name, cell):
    """A replacement for mitsuba_tpu_torch.renderer.render."""
    from mitsuba_tpu_torch import renderer

    orig = renderer.render

    def fault(scene, spp=None, seed=0, **kw):
        if name == "state_unchanged":  # the film as it started: nothing added
            img = np.zeros_like(orig(scene, spp=1, seed=seed, **kw))
        elif name == "half_left_out":  # half of the samples, the mean of the rest
            img = orig(scene, spp=max(spp // 2, 1), seed=seed, **kw)
        elif name == "answer_altered":  # every pixel 25 % high
            img = orig(scene, spp=spp, seed=seed, **kw) * np.float32(1.25)
        elif name == "control_bf16":
            img = _bf16_image(cell, scene, spp, seed)
        else:
            raise ValueError(name)
        fault.last_ray_count = 0
        return img

    return fault


RENDER_FAULTS = ("state_unchanged", "half_left_out", "answer_altered", "control_bf16")


def test_render_sound():
    res = execute(small_cell("cbox.hd"))
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("fault", RENDER_FAULTS)
def test_render_fault_fails(fault, monkeypatch):
    from mitsuba_tpu_torch import renderer

    cell = small_cell("cbox.hd")
    monkeypatch.setattr(renderer, "render", render_fault(fault, cell))
    res = execute(cell)
    assert not res["correct"], res["check"]


# --- four ranks ------------------------------------------------------------

def faulty_rank_main(rank, world, payload):
    """ranks.rank_main with the fault named in the environment planted in
    this rank's program."""
    from mitsuba_tpu_torch.parallel import mesh as pm

    name = os.environ[FAULT_ENV]
    orig = pm.render_sharded
    if name == "exchange_left_out":
        pm.Mesh.all_reduce = lambda self, t: t
    elif name in ("state_unchanged", "half_left_out", "answer_altered"):
        def fault(scene, mesh=None, spp=None, seed=0, spp_chunk=None):
            if name == "state_unchanged":
                img = np.zeros_like(orig(scene, mesh=mesh, spp=world, seed=seed))
            elif name == "half_left_out":
                img = orig(scene, mesh=mesh, spp=max(spp // 2, world), seed=seed)
            else:
                img = orig(scene, mesh=mesh, spp=spp, seed=seed) * np.float32(1.25)
            fault.last_ray_count = orig.last_ray_count
            return img
        pm.render_sharded = fault
    ranks.rank_main(rank, world, payload)


def _sharded(monkeypatch, fault):
    cell = small_cell("cbox.hd.x4")
    monkeypatch.setenv(FAULT_ENV, fault)
    monkeypatch.setattr(cell.driver, "ranks", types.SimpleNamespace(rank_main=faulty_rank_main))
    return execute(cell)


def test_sharded_sound(monkeypatch):
    res = _sharded(monkeypatch, "none")
    assert res["correct"], res["check"]
    assert res["device"]["count"] == 4


@pytest.mark.parametrize("fault", ["exchange_left_out", "state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_sharded_fault_fails(fault, monkeypatch):
    res = _sharded(monkeypatch, fault)
    assert not res["correct"], res["check"]
