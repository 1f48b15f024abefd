"""The port's entry points (mitsuba_tpu_torch/entry.py): `entry` on the
CPU gives one pass of cbox at 64x64 (alpha, the filter weight, above 0
everywhere); `dryrun_multichip(2, device="cpu")` runs one sharded step of
path, volpath, bdpt, pssmlt and sppm on two gloo ranks; on the card (the
default) it needs two cards, and without them it raises before spawning
anything."""

import pytest
import torch

from mitsuba_tpu_torch.entry import dryrun_multichip, entry

torch.set_num_threads(1)


def test_entry_on_cpu():
    fn, args = entry(device="cpu")
    film, rays = fn(*args)
    assert tuple(film.shape) == (64, 64, 4) and film.device.type == "cpu"
    assert bool((film[..., 3] > 0).all()) and bool(torch.isfinite(film).all())
    assert int(rays) > 0


def test_entry_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_dryrun_multichip_cpu():
    dryrun_multichip(2, device="cpu", timeout_s=240.0)


def test_dryrun_multichip_needs_cards():
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards"):
        dryrun_multichip(2)
