"""The port's render service (mitsuba_tpu_torch/parallel/service.py),
mtssrv's counterpart, with worker processes on the CPU (tests/
test_service.py's cases).

The film of the service equals the local pass loop's bit for bit: units
are whole passes, the counter RNG makes any worker's unit byte-identical,
and the master adds the films in unit order.  With three workers, one is
killed (SIGKILL) once its first unit has arrived; its next unit is
re-queued on the survivors and the film is still bit-identical.  Every
test bounds its render's time, and the service is shut down in `finally`.
"""

import os
import signal
import threading

import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.parallel.service import RenderService

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "scenes", "cbox.xml")
SIZE = 32
SPP = 12
CHUNK = 1
RENDER_S = 240.0


def _worker_env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # one CPU thread a worker: the test runner shares the cores
    return env


@pytest.fixture(scope="module")
def local():
    """The local single-process pass loop's (image, film)."""
    scene = mt.load_scene(SCENE)
    scene.sensor.record.film.width = scene.sensor.record.film.height = SIZE
    img, film = mt.render(scene, spp=SPP, seed=0, device="cpu",
                          lanes_per_pass=CHUNK * SIZE * SIZE, return_film=True)
    return img, film.numpy()


def _service_render(n_workers, kill_first=False):
    svc = RenderService(n_workers=n_workers, worker_env=_worker_env(), device="cpu")
    killed = []

    def progress(done, n, pid):
        # kill a worker once its first unit has arrived: its next unit
        # is in flight or about to be, and must be re-queued
        if kill_first and not killed:
            killed.append(pid)
            os.kill(pid, signal.SIGKILL)

    try:
        sid = svc.broadcast_scene(SCENE, film_size={"width": SIZE, "height": SIZE})
        out = {}

        def run():
            out["img"], out["film"] = svc.render(sid, w=SIZE, h=SIZE, spp=SPP, spp_chunk=CHUNK,
                                                 progress=progress)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=RENDER_S)
        assert not t.is_alive(), "the service's render did not finish in time"
        assert "film" in out, "the service's render raised"
        return out["img"], out["film"], svc, killed
    finally:
        svc.shutdown()


def test_service_matches_local_bitexact(local):
    img, film, svc, _ = _service_render(2)
    assert not any(w.dead for w in svc.workers) and svc.requeued == []
    np.testing.assert_array_equal(film, local[1])
    np.testing.assert_array_equal(img, local[0])


def test_service_survives_worker_kill_bitexact(local):
    img, film, svc, killed = _service_render(3, kill_first=True)
    dead = [w.pid for w in svc.workers if w.dead]
    assert dead == killed and len(svc.requeued) >= 1
    np.testing.assert_array_equal(film, local[1])
    np.testing.assert_array_equal(img, local[0])
