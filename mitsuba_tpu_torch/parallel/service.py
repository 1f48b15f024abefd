"""The render service, mtssrv's counterpart (port of
mitsuba_tpu/parallel/service.py; reference src/mitsuba/mtssrv.cpp:101,
src/libcore/sched_remote.cpp:333-431, protocol sched_remote.h:221):
persistent worker processes, a scene broadcast once, centrally queued
work units, and re-queue of the units lost to a worker's death.

* A work unit is one render pass: the film of samples [s0, s0 +
  spp_chunk) over the whole frame.  The counter RNG keys samples
  globally, so any worker renders any unit byte for byte.
* The scene goes to each worker once per scene id, which caches its pack
  (ENewResource and the resource cache, sched_remote.h:384).
* The master adds the films in unit order: the float additions of the
  local pass loop, so the film is bit-identical to it however the units
  were spread, and after a death.
* A worker's death (end of stream, a socket error or a timeout) re-queues
  its unit on the survivors (Scheduler::cancel, sched.h:143-156); the
  render completes while one worker lives.

Messages are length-prefixed pickles over local sockets: the service
trusts its peers as mtssrv trusts its cluster.  Workers are processes of
the port with an explicit device: `cuda:{i % cards}` on the card, "cpu"
only when asked.  Every socket operation and every wait has a time limit.
"""

from __future__ import annotations

import math
import os
import pickle
import socket
import struct
import subprocess
import sys
import threading

import numpy as np

from mitsuba_tpu_torch.core.logging import logger

_HDR = struct.Struct("<Q")
# seconds a worker may take to start and connect, to load a scene, and to
# render one unit; a worker idle for IDLE_S between messages exits
CONNECT_S = 300.0
SCENE_S = 600.0
UNIT_S = 600.0
IDLE_S = 3600.0


def _send(sock, obj):
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv(sock):
    """The next message, or None at the end of the stream."""
    hdr = b""
    while len(hdr) < _HDR.size:
        chunk = sock.recv(_HDR.size - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = _HDR.unpack(hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return pickle.loads(bytes(buf))


# ---------------------------------------------------------------------------
# the worker (mtssrv, StreamBackend::run)
# ---------------------------------------------------------------------------

def _render_unit(scene, pack, unit, device):
    """One work unit: the film [H, W, 4] of samples [s0, s0 + spp_chunk),
    one pass of the local pass loop (renderer.make_render_pass), as numpy."""
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.renderer import make_render_pass

    sensor_rec = scene.sensor.record
    film_rec = sensor_rec.film
    rp = make_render_pass(pack, scene.integrator, sensor_rec, film_rec, sensor_rec.sampler,
                          unit["spp_chunk"], device)
    film, _ = rp(new_film(film_rec.height, film_rec.width, device), unit["s0"], unit["seed"])
    return film.cpu().numpy()


def worker_loop(host, port, device, idle_s=IDLE_S):
    """A persistent worker on `device`: connect, then serve scenes and
    units until told to quit, the master goes away or `idle_s` pass
    without a message (StreamBackend::run, sched_remote.cpp:333)."""
    import torch

    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device)
    sock = socket.create_connection((host, port), timeout=CONNECT_S)
    sock.settimeout(idle_s)
    scenes = {}  # scene id -> (scene, pack): the resource cache
    try:
        _send(sock, {"type": "hello", "pid": os.getpid()})
        while True:
            msg = _recv(sock)
            if msg is None or msg["type"] == "quit":
                break
            if msg["type"] == "scene":
                scene = mt.load_scene(msg["path"])
                for k, v in (msg.get("film_size") or {}).items():
                    setattr(scene.sensor.record.film, k, v)
                scenes[msg["scene_id"]] = (scene, pack_scene(scene, device))
                _send(sock, {"type": "scene_ok", "scene_id": msg["scene_id"]})
            elif msg["type"] == "unit":
                scene, pack = scenes[msg["scene_id"]]
                try:
                    film = _render_unit(scene, pack, msg, device)
                except Exception as e:  # noqa: BLE001 — reported to the master, which raises
                    _send(sock, {"type": "error", "unit_id": msg["unit_id"],
                                 "error": f"{type(e).__name__}: {e}"})
                    continue
                _send(sock, {"type": "result", "unit_id": msg["unit_id"], "film": film})
    finally:
        sock.close()


# ---------------------------------------------------------------------------
# the master (RemoteWorker and the Scheduler's queue)
# ---------------------------------------------------------------------------

class _Worker:
    def __init__(self, sock):
        self.sock = sock
        self.proc = None  # its process, when this service spawned it
        self.pid = None
        self.dead = False


class RenderService:
    """The master: spawns `n_workers` persistent workers, broadcasts a
    scene once, queues pass units, adds the films in unit order, and
    re-queues the units of dead workers.

    device: "cuda" gives worker i the card `cuda:{i % cards}`; "cpu" runs
    every worker on the CPU; a "cuda:k" puts them all on card k.
    RenderService.requeued lists the units re-queued after deaths."""

    def __init__(self, n_workers=2, worker_env=None, device="cuda"):
        self.listener = socket.socket()
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(n_workers)
        self.listener.settimeout(CONNECT_S)
        self.port = self.listener.getsockname()[1]
        self.workers = []
        self.requeued = []
        self._scene_seq = 0
        self._procs = {}  # pid -> the worker process this service spawned
        try:
            env = dict(os.environ if worker_env is None else worker_env)
            # the workers import this package from the same checkout
            root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
            for i in range(n_workers):
                proc = subprocess.Popen(
                    [sys.executable, "-m", "mitsuba_tpu_torch.parallel.service", "--worker",
                     "--connect", f"127.0.0.1:{self.port}", "--device", worker_device(device, i)],
                    env=env)
                self._procs[proc.pid] = proc
            for _ in range(n_workers):
                self._accept()
        except BaseException:
            self.shutdown()
            raise

    def _accept(self):
        try:
            sock, _ = self.listener.accept()
        except socket.timeout:
            codes = {pid: p.poll() for pid, p in self._procs.items()}
            raise RuntimeError(f"service: a worker did not connect in time (the spawned "
                               f"workers' exit codes: {codes})") from None
        w = _Worker(sock)
        self.workers.append(w)
        sock.settimeout(SCENE_S)
        hello = _recv(sock)
        if not hello or hello["type"] != "hello":
            raise RuntimeError(f"service: a worker sent {hello!r} for hello")
        w.pid = hello["pid"]
        w.proc = self._procs.get(w.pid)
        return w

    def worker_pids(self):
        return [w.pid for w in self.workers]

    def broadcast_scene(self, path, film_size=None):
        """Send the scene once to every live worker (ENewResource); returns
        its id for render().  A worker that fails to load it is dead."""
        self._scene_seq += 1
        sid = self._scene_seq
        msg = {"type": "scene", "scene_id": sid, "path": os.path.abspath(path),
               "film_size": film_size}
        for w in self._live():
            try:
                w.sock.settimeout(SCENE_S)
                _send(w.sock, msg)
                ok = _recv(w.sock)
            except OSError:
                ok = None
            if not ok or ok["type"] != "scene_ok":
                self._mark_dead(w)
        return sid

    def _mark_dead(self, w):
        if not w.dead:
            w.dead = True
            logger.warn("service: worker pid=%s died", w.pid)
            try:
                w.sock.close()
            except OSError:
                pass
            if w.proc is not None and w.proc.poll() is None:
                w.proc.kill()  # a worker that timed out may still be running

    def _live(self):
        return [w for w in self.workers if not w.dead]

    def render(self, scene_id, *, w, h, spp, spp_chunk=1, seed=0, ray_weight=1.0,
               progress=None):
        """The distributed pass loop; returns (the developed image, the film
        [H, W, 4]) as numpy.  Unit i covers samples [i spp_chunk, (i + 1)
        spp_chunk); the films add in unit order, so the result is
        bit-identical to the local pass loop whoever rendered which unit,
        deaths included.  progress(units done, units, worker pid) is called
        after each unit's film arrives (from the worker's thread).  A
        worker that sends nothing for UNIT_S seconds is dead."""
        import torch

        from mitsuba_tpu_torch.film.film import develop

        n_units = math.ceil(spp / spp_chunk)
        queue = list(range(n_units))
        results = {}
        errors = []
        lock = threading.Lock()

        def pump(worker):
            worker.sock.settimeout(UNIT_S)
            while True:
                with lock:
                    if not queue or errors:
                        return
                    uid = queue.pop(0)
                unit = {"type": "unit", "unit_id": uid, "scene_id": scene_id,
                        "s0": uid * spp_chunk, "spp_chunk": spp_chunk, "seed": seed}
                try:
                    _send(worker.sock, unit)
                    msg = _recv(worker.sock)
                except OSError:  # a reset, or the time limit (socket.timeout)
                    msg = None
                if msg is None:
                    # the worker died: its unit goes back to the queue's head
                    with lock:
                        queue.insert(0, uid)
                        self.requeued.append(uid)
                        self._mark_dead(worker)
                    return
                if msg["type"] == "error":
                    with lock:
                        errors.append(f"unit {uid} failed on worker pid={worker.pid}: "
                                      f"{msg['error']}")
                    return
                with lock:
                    results[msg["unit_id"]] = msg["film"]
                    done = len(results)
                if progress is not None:
                    progress(done, n_units, worker.pid)

        while len(results) < n_units:
            live = self._live()
            if not live:
                raise RuntimeError("service: all workers died")
            threads = [threading.Thread(target=pump, args=(w_,), daemon=True) for w_ in live]
            for t in threads:
                t.start()
            for t in threads:
                # each unit ends within UNIT_S, or its worker is dead
                t.join(timeout=UNIT_S * (n_units + 1))
                if t.is_alive():
                    raise RuntimeError("service: a worker's thread did not finish")
            if errors:
                raise RuntimeError("service: " + "; ".join(errors))

        # the local pass loop's additions, in unit order
        film = results[0].astype(np.float32)
        for uid in range(1, n_units):
            film = film + results[uid]
        img = (develop(torch.as_tensor(film)) * ray_weight).numpy()
        return img, film

    def shutdown(self):
        """Tell the live workers to quit and wait for every process (killed
        after 30 s)."""
        self.listener.close()  # a worker not yet accepted sees its connection reset
        for w in self.workers:
            if not w.dead:
                try:
                    _send(w.sock, {"type": "quit"})
                except OSError:
                    pass
                w.sock.close()
        for proc in self._procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


def worker_device(device, i):
    """Worker i's device: the card `cuda:{i % cards}` for "cuda" (raises
    without a card), else `device` itself."""
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the workers on the CPU")
        return f"cuda:{i % torch.cuda.device_count()}"
    return str(torch.device(device))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="mitsuba_tpu_torch render service (mtssrv's "
                                             "counterpart)")
    ap.add_argument("--worker", action="store_true", help="run as a persistent worker")
    ap.add_argument("--connect", default=None, help="the master's host:port")
    ap.add_argument("--device", default="cuda",
                    help="a worker's device, or the master's for its workers: 'cuda' (card i "
                         "%% cards for worker i), 'cuda:k' or 'cpu'")
    ap.add_argument("scene", nargs="?")
    ap.add_argument("-o", "--output", default="out.exr")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--spp-chunk", type=int, default=4)
    args = ap.parse_args(argv)

    if args.worker:
        host, port = args.connect.rsplit(":", 1)
        worker_loop(host, int(port), args.device)
        return 0

    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.io.images import write_image

    scene = mt.load_scene(args.scene)
    film = scene.sensor.record.film
    svc = RenderService(n_workers=args.workers, device=args.device)
    try:
        sid = svc.broadcast_scene(args.scene)
        img, _ = svc.render(sid, w=film.width, h=film.height, spp=args.spp,
                            spp_chunk=args.spp_chunk, ray_weight=scene.sensor.record.ray_weight)
    finally:
        svc.shutdown()
    write_image(args.output, img)
    return 0


if __name__ == "__main__":
    sys.exit(main())
