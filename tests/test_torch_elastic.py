"""The port's elastic pass loop (mitsuba_tpu_torch/parallel/elastic.py):
tests/test_elastic.py's five cases against the port's `render`, whose
pass loop runs through `run_passes`, on the CPU.

A fault hook raises a SimulatedFault before a pass; the loop re-queues
the lost passes from the checkpoint (or from a clean film) and the image
is bit-identical to an uninterrupted render (the counter RNG).  Errors
that a retry would only hide are not recoverable: a kernel launch's
error (native.launch), a failed nvcc build, an out-of-memory error,
CUDA's sticky errors and any error that does not name a lost peer.
`render_elastic` rebuilds its mesh after a recoverable failure: two gloo
ranks whose first mesh fails render again, each on a world of one, at
tests/test_elastic.py's gate (atol 2e-5).
"""

import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.parallel import elastic
from mitsuba_tpu_torch.parallel.mesh import spawn_ranks
from tests.torch_ranks import elastic_shrink

torch.set_num_threads(1)

SIZE = 48
SPP = 8


@pytest.fixture
def cbox():
    scene = mt.load_scene("scenes/cbox.xml")
    scene.sensor.record.film.width = scene.sensor.record.film.height = SIZE
    return scene


@pytest.fixture
def hook():
    """Install a fault hook for one test: hook(fn) sets it, and it is
    removed afterwards."""
    def install(fn):
        elastic._fault_hook = fn

    try:
        yield install
    finally:
        elastic._fault_hook = None


def _render(scene, **kw):
    # 8 passes of 1 spp
    return mt.render(scene, spp=SPP, seed=5, device="cpu", lanes_per_pass=SIZE * SIZE, **kw)


def test_requeue_from_checkpoint(cbox, hook, tmp_path):
    """A fault at pass 3 with a checkpoint every 2 passes: passes 2..7
    re-render, and the image is the uninterrupted one bit for bit."""
    clean = _render(cbox)
    seen = []

    def fault(i):
        seen.append(i)
        if i == 3 and seen.count(3) == 1:
            raise elastic.SimulatedFault(i)

    hook(fault)
    img = _render(cbox, checkpoint=str(tmp_path / "ck.npz"), checkpoint_every=2)
    assert seen == [0, 1, 2, 3, 2, 3, 4, 5, 6, 7]
    np.testing.assert_array_equal(img, clean)


def test_requeue_from_scratch(cbox, hook):
    """No checkpoint: the whole render re-queues and still matches."""
    clean = _render(cbox)
    seen = []

    def fault(i):
        seen.append(i)
        if i == 1 and seen.count(1) == 1:
            raise elastic.SimulatedFault(i)

    hook(fault)
    img = _render(cbox)
    assert seen == [0, 1, *range(8)]
    np.testing.assert_array_equal(img, clean)


def test_unrecoverable_raises(cbox, hook):
    seen = []

    def fault(i):
        seen.append(i)
        raise ValueError("a real bug, not a device failure")

    hook(fault)
    with pytest.raises(ValueError):
        _render(cbox)
    assert seen == [0]  # no retry


def test_retry_budget_exhausted(cbox, hook, monkeypatch):
    """Persistent failures surface after MTS_TPU_RETRIES attempts."""
    seen = []

    def fault(i):
        seen.append(i)
        raise elastic.SimulatedFault(i)

    hook(fault)
    monkeypatch.setenv("MTS_TPU_RETRIES", "1")
    with pytest.raises(elastic.SimulatedFault):
        _render(cbox)
    assert seen == [0, 0]


FATAL = {
    "launch": RuntimeError("brute_closest: CUDA error 700 at launch"),
    "nvcc": RuntimeError("nvcc failed for csrc/brute_tiled.cu (exit 1):\n"),
    "oom": torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    "sticky": RuntimeError("CUDA error: an illegal memory access was encountered"),
    "dist-wrapped-cuda": torch.distributed.DistBackendError(
        "NCCL error: unhandled cuda error, CUDA error: an illegal memory access"),
    "value": ValueError("shape mismatch"),
    "plain-runtime": RuntimeError("index 7 is out of bounds"),
}
RECOVERABLE = {
    "simulated": elastic.SimulatedFault(3),
    "dist-backend": torch.distributed.DistBackendError("NCCL communicator was aborted"),
    "dist-network": torch.distributed.DistNetworkError("failed to recv, got 0 bytes"),
    "gloo-closed": RuntimeError("[gloo/transport/tcp/pair.cc:534] Connection closed by peer "
                                "[127.0.0.1]:40123"),
    "gloo-reset": RuntimeError("Read error [127.0.0.1]:40123: Connection reset by peer"),
    "nccl-timeout": RuntimeError("Watchdog caught collective operation timeout"),
}


@pytest.mark.parametrize("name", FATAL)
def test_fatal_errors_are_not_recoverable(name):
    assert not elastic.is_recoverable(FATAL[name])


@pytest.mark.parametrize("name", RECOVERABLE)
def test_lost_peers_are_recoverable(name):
    assert elastic.is_recoverable(RECOVERABLE[name])


@pytest.mark.parametrize("name", ("launch", "oom"))
def test_kernel_and_oom_errors_are_not_retried(cbox, hook, name):
    """A launch error or an out-of-memory error in a pass surfaces at
    once: a retry would hide a fault of the kernel or the device."""
    seen = []

    def fault(i):
        seen.append(i)
        if i == 2:
            raise FATAL[name]

    hook(fault)
    with pytest.raises(type(FATAL[name])):
        _render(cbox)
    assert seen == [0, 1, 2]


def test_render_elastic_shrinks_mesh(tmp_path):
    """Two gloo ranks: render_sharded on the world of two, then
    render_elastic whose first mesh fails and whose second is a world of
    one; both images agree at tests/test_elastic.py's gate."""
    spawn_ranks(elastic_shrink, 2, (f"file://{tmp_path}/store", str(tmp_path)), 240.0)
    for r in range(2):
        out = np.load(tmp_path / f"rank{r}.npz")
        assert int(out["calls"]) == 2
        assert np.isfinite(out["elastic"]).all() and out["elastic"].mean() > 0.01
        np.testing.assert_allclose(out["elastic"], out["full"], atol=2e-5)
