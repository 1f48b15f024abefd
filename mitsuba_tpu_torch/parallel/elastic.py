"""Failure detection and work re-queue (port of
mitsuba_tpu/parallel/elastic.py; reference Scheduler::cancel,
include/mitsuba/core/sched.h:143-156, and sched_remote.cpp's handling of
a dead worker).

A work unit is one render pass.  A pass lost to a failure that a new
attempt can outlive (a peer, store or collective of torch.distributed
that failed, or the tests' simulated fault) is re-queued from the last
host-side state: the checkpoint when the render keeps one, else a clean
film.  The counter RNG re-derives every lost sample, so a re-queued
render is bit-identical to an uninterrupted one.

What a retry would only hide is not recoverable: a failed nvcc build, an
error from a kernel launch (`native.launch`), running out of device
memory, and CUDA's sticky errors (an illegal address leaves the context
unusable).  Neither is any other exception.
"""

from __future__ import annotations

import os
import time

import torch

from mitsuba_tpu_torch.core.logging import logger

# message fragments of the faults that a retry would only hide: CUDA's
# errors (launch errors of native.launch, sticky context errors), a failed
# build, running out of memory
_FATAL_MARKERS = (
    "out of memory",
    "cuda error",
    "illegal memory access",
    "illegal instruction",
    "misaligned address",
    "device-side assert",
    "unspecified launch failure",
    "at launch",
    "nvcc",
)
# message fragments of a lost peer in gloo's and NCCL's runtime errors
_RECOVERABLE_MARKERS = (
    "connection closed by peer",
    "connection reset by peer",
    "connection refused",
    "broken pipe",
    "remote process exited",
    "communicator was aborted",
    "collective operation timeout",
    "socket timeout",
    "simulated fault",
)

# test hook: a callable given the pass index before each pass; it may raise
_fault_hook = None


class SimulatedFault(RuntimeError):
    """Raised by test fault hooks; recoverable."""

    def __init__(self, i):
        super().__init__(f"simulated fault at pass {i}")


def is_recoverable(e) -> bool:
    """Whether a new attempt may outlive `e`: the simulated fault, an error
    of torch.distributed, or a runtime or OS error naming a lost peer;
    never an out-of-memory error or a message of the fatal kinds above."""
    if isinstance(e, torch.OutOfMemoryError):
        return False
    msg = str(e).lower()
    if any(m in msg for m in _FATAL_MARKERS):
        return False
    # DistError: the base of torch.distributed's backend, network and store errors
    if isinstance(e, (SimulatedFault, getattr(torch.distributed, "DistError", ()))):
        return True
    return isinstance(e, (RuntimeError, OSError)) and any(m in msg for m in _RECOVERABLE_MARKERS)


def max_retries(default=2) -> int:
    return int(os.environ.get("MTS_TPU_RETRIES", str(default)))


def run_passes(build_fn, run_pass, n_passes, *, film_init, device, reload_state=None,
               after_pass=None, retries=None):
    """The resilient work-unit loop.

    build_fn(attempt) -> the pass function (attempt 0 first; later
    attempts follow a failure); film_init() -> a fresh film;
    reload_state() -> (film as numpy, next pass) or None (the checkpoint:
    also the re-queue point); run_pass(rp, film, i) -> film;
    after_pass(film, i) (checkpoints, progress).  A reloaded film goes to
    `device`.  Returns the final film.  Lost passes are re-queued from the
    last reloadable state, at most `retries` times (MTS_TPU_RETRIES, 2)."""
    retries = max_retries() if retries is None else retries
    attempt = 0
    while True:
        try:
            rp = build_fn(attempt)
            film, i0 = None, 0
            if reload_state is not None:
                st = reload_state()
                if st is not None:
                    film, i0 = torch.as_tensor(st[0], device=device), int(st[1])
                    if attempt:
                        logger.info("render: re-queueing passes %d..%d", i0, n_passes - 1)
            if film is None:
                film = film_init()
                if attempt:
                    logger.info("render: re-queueing passes 0..%d", n_passes - 1)
            for i in range(i0, n_passes):
                if _fault_hook is not None:
                    _fault_hook(i)
                film = run_pass(rp, film, i)
                if after_pass is not None:
                    after_pass(film, i)
            return film
        except Exception as e:  # noqa: BLE001 — filtered below, re-raised unless recoverable
            if attempt >= retries or not is_recoverable(e):
                raise
            attempt += 1
            logger.warn("render pass failed (%s: %s) — re-queueing lost work (attempt %d/%d)",
                        type(e).__name__, e, attempt, retries)
            time.sleep(min(2.0 * attempt, 10.0))


def render_elastic(scene, spp=None, seed=0, retries=None, mesh_fn=None):
    """An elastic sharded render: after a recoverable failure `mesh_fn`
    (default `make_mesh`, the card) is called again, so that the render
    resumes on whatever world it returns now.  The counter RNG keys
    samples globally, so a smaller world changes only the time taken."""
    from mitsuba_tpu_torch.parallel.mesh import make_mesh, render_sharded

    retries = max_retries() if retries is None else retries
    mesh_fn = mesh_fn or make_mesh
    attempt = 0
    while True:
        try:
            mesh = mesh_fn()
            if attempt:
                logger.info("render_elastic: retrying on %d rank(s)", mesh.world)
            return render_sharded(scene, mesh=mesh, spp=spp, seed=seed)
        except Exception as e:  # noqa: BLE001 — filtered below, re-raised unless recoverable
            if attempt >= retries or not is_recoverable(e):
                raise
            attempt += 1
            logger.warn("render_elastic: render failed (%s) — rebuilding the mesh "
                        "(attempt %d/%d)", e, attempt, retries)
            time.sleep(min(2.0 * attempt, 10.0))
