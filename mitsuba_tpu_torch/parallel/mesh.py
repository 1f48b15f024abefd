"""Multi-card rendering over torch.distributed (port of
mitsuba_tpu/parallel/mesh.py).

The reference renders on a jax.sharding.Mesh: the scene pack is
replicated, the sample-lane axis is sharded, and a `psum` merges the
per-chip films.  Here every rank is one process with one device:

* the mesh is a small record (`Mesh`): the process group, this rank, the
  world size, this rank's device and the backend.  `make_mesh` wraps the
  default group, or is a world of one when no group is initialised;
* the backend is always the caller's: NCCL on the card with one rank per
  card, gloo in the CPU tests or where the caller names it.  Nothing here
  switches backend, device or collective when something is missing: a
  missing card or a mismatched backend raises;
* `psum` becomes `dist.all_reduce(SUM)`, and the tiled `all_gather` a
  `dist.all_gather` over equal padded shards;
* every rank packs the scene itself and gets the developed image back,
  as the reference's replicated result.

The counter RNG keys every sample by (pixel, sample index), so the split
changes only the order of the film's float sums.  The work split and its
arithmetic are the reference's: sample layers per rank for the path
family (`spp_chunk` rounded up to a multiple of the world), both films of
bdpt, eye and photon lanes of the photon mappers, particles of ptracer,
pass ids of vpl, and chains of the Metropolis family (integrator/pssmlt.py
and integrator/mlt.py take `mesh=`).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch

from mitsuba_tpu_torch.core.logging import logger

_MASK = 0xFFFFFFFF
BACKENDS = ("nccl", "gloo")
# lanes of one sharded pass per rank (reference mesh.py:461, :240)
PATH_LANES_PER_RANK = 1 << 21
BDPT_LANES_PER_RANK = 1 << 17


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the world: `group` is None for a world of one
    without a process group, where the collectives are the identity."""

    group: object
    rank: int
    world: int
    device: torch.device
    backend: str | None

    def shard(self, n):
        """This rank's [start, stop) of n lanes (n a multiple of world)."""
        if n % self.world:
            raise ValueError(f"{n} lanes do not split over {self.world} ranks")
        k = n // self.world
        return self.rank * k, (self.rank + 1) * k

    def all_reduce(self, t):
        """Sum `t` over the ranks in place; returns it."""
        if self.group is not None:
            torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t):
        """Every rank's equal shard `t`, concatenated in rank order along
        dim 0 (bool shards travel as uint8)."""
        if self.group is None:
            return t
        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        torch.distributed.all_gather(parts, src, group=self.group)
        out = torch.cat(parts)
        return out.to(torch.bool) if t.dtype == torch.bool else out


def local_rank() -> int:
    """This process's card on its host: LOCAL_RANK (as torchrun sets it),
    else 0."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def resolve_device(device, backend=None):
    """The device a rank renders on.  A bare "cuda" is cuda:LOCAL_RANK.
    Raises when the card is missing, or NCCL is asked for off the card."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to render on the CPU")
        if device.index is None:
            device = torch.device("cuda", local_rank())
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"{device} asked for, but {torch.cuda.device_count()} card(s) "
                               f"are visible")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
    return device


def make_mesh(group=None, device="cuda", backend=None):
    """The mesh of `group` (the default group when None) on `device` (the
    card unless the caller asks for "cpu").  Without an initialised
    process group it is a world of one.  `backend`, when given, must be
    the group's."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        actual = dist.get_backend(group)
        if backend is not None and backend != actual:
            raise ValueError(f"backend {backend!r} asked for, but the group runs {actual!r}")
        return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                    resolve_device(device, actual), actual)
    if group is not None or backend is not None:
        raise ValueError("a group or backend was given, but no process group is initialised")
    return Mesh(None, 0, 1, resolve_device(device), None)


def init_world(backend, init_method, world_size, rank, device=None, timeout_s=60.0):
    """Join a process group: `backend` ("nccl" or "gloo") is required, as
    is the rendezvous (`tcp://host:port` or `file:///path`); collectives
    and the rendezvous time out after `timeout_s`.  Under NCCL `device` is
    this rank's card, made current first."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if backend == "nccl":
        torch.cuda.set_device(resolve_device(device or "cuda", backend))
    torch.distributed.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=timedelta(seconds=timeout_s))


def destroy_world():
    """Leave the process group, if one is initialised."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def spawn_ranks(fn, world, args=(), timeout_s=600.0):
    """Run fn(rank, world, *args) in `world` spawned processes and wait at
    most `timeout_s` for all of them.  Raises when one raises (with its
    traceback), exits non-zero or is still running at the deadline; every
    process is stopped before it returns."""
    import torch.multiprocessing as tmp

    ctx = tmp.start_processes(fn, args=(world, *args), nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(min(deadline - time.monotonic(), 5.0), 0.05)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


# ---------------------------------------------------------------------------
# the path family: sample layers per rank
# ---------------------------------------------------------------------------

def make_sharded_render_pass(pack, integ, sensor_rec, film_rec, sampler_rec, spp_chunk, mesh):
    """One render pass over the mesh: fn(film, sample_base, seed) ->
    (film, n_rays), n_rays the rays this rank traced (an int64 tensor).

    The sample grid is [spp_chunk, pixels]; spp_chunk is rounded up to a
    multiple of the world and each rank renders the sample layers
    [rank spp_local, (rank + 1) spp_local) of the whole film, then one
    all-reduce adds the ranks' contributions (reference mesh.py:42-173).
    Path-like traces on scenes without media under an importance-sampled
    filter take the regenerating wavefront, one lane per pixel; layers
    past spp_chunk scale the rank's contribution by the share of its
    layers that count.  Otherwise the batched wavefront splats each
    layer, the layers past spp_chunk masked out."""
    from mitsuba_tpu_torch.film.film import splat_grid
    from mitsuba_tpu_torch.film.plugins import filter_importance_sample, supports_fis
    from mitsuba_tpu_torch.integrator import volpath  # noqa: F401 (registers "volpath")
    from mitsuba_tpu_torch.integrator.path import TRACE_FNS, path_trace_regen
    from mitsuba_tpu_torch.sensor.plugins import generate_rays

    device = mesh.device
    w, h = film_rec.width, film_rec.height
    n_px = w * h
    cam = sensor_rec.pack(w, h, device)
    rfilter = film_rec.rfilter
    if integ.kind not in TRACE_FNS:
        raise NotImplementedError(f"integrator '{integ.kind}' has no sharded pass")
    trace = TRACE_FNS[integ.kind]
    spp_pad = math.ceil(spp_chunk / mesh.world) * mesh.world
    spp_local = spp_pad // mesh.world
    layer0 = mesh.rank * spp_local
    # the layers of this rank below spp_chunk
    n_layers = min(max(spp_chunk - layer0, 0), spp_local)
    has_media = pack.meta.get("has_media", False)
    # volpath on a medium-free scene is exactly the path integrator
    path_like = integ.kind == "path" or (integ.kind == "volpath" and not has_media)
    use_regen = path_like and supports_fis(rfilter) and not has_media
    px = torch.arange(n_px, dtype=torch.int64, device=device)

    if use_regen:
        spp_here = min(spp_local, spp_chunk)
        px_x, px_y = (px % w).to(torch.float32), (px // w).to(torch.float32)
        frac = torch.clamp(torch.tensor(float(n_layers), dtype=torch.float32) / max(spp_here, 1),
                           max=1.0).item()

        def render_pass(film, sample_base, seed):
            sidx_off = (sample_base + layer0) & _MASK

            def make_ray(sample_i):
                sidx = sidx_off + sample_i.to(torch.int64)
                u2 = sampler_rec.pixel_sample(px, sidx, sampler_rec.sample_count)
                jitter = filter_importance_sample(rfilter, u2)
                pos01 = torch.stack([(px_x + jitter[..., 0]) / w, (px_y + jitter[..., 1]) / h],
                                    dim=-1)
                u_lens = (sampler_rec.lens_sample(px, sidx) if cam["use_lens"]
                          else torch.zeros_like(u2))
                return generate_rays(cam, pos01, u_lens)

            L_sum, n_done, n_rays = path_trace_regen(
                pack, integ, make_ray, n_px, spp_here, px, sampler_rec, seed,
                sidx_offset=sidx_off)
            contrib = torch.cat([L_sum * frac, n_done.to(torch.float32)[..., None] * frac],
                                dim=-1).reshape(h, w, 4)
            return film + mesh.all_reduce(contrib), n_rays

        return render_pass

    layers = layer0 + torch.arange(spp_local, dtype=torch.int64, device=device)[:, None]
    lane = px[None, :].expand(spp_local, n_px).reshape(-1)
    px_x, px_y = (lane % w).to(torch.float32), (lane // w).to(torch.float32)
    # layers past spp_chunk add neither radiance nor filter weight
    layer_valid = (layers < spp_chunk)[:, :, None].expand(spp_local, h, w)

    def render_pass(film, sample_base, seed):
        sidx = ((sample_base + layers) & _MASK).expand(spp_local, n_px).reshape(-1)
        jitter = sampler_rec.pixel_sample(lane, sidx, sampler_rec.sample_count)
        pos01 = torch.stack([(px_x + jitter[..., 0]) / w, (px_y + jitter[..., 1]) / h], dim=-1)
        u_lens = (sampler_rec.lens_sample(lane, sidx) if cam["use_lens"]
                  else torch.zeros_like(jitter))
        o, d = generate_rays(cam, pos01, u_lens)
        L = trace(pack, integ, o, d, lane, sidx, sampler_rec, seed)
        local = splat_grid(torch.zeros_like(film), jitter.reshape(spp_local, h, w, 2),
                           L.reshape(spp_local, h, w, 3), rfilter, valid=layer_valid)
        return film + mesh.all_reduce(local), trace.last_ray_count

    return render_pass


# ---------------------------------------------------------------------------
# bdpt: both films all-reduced
# ---------------------------------------------------------------------------

def make_sharded_bdpt_pass(pack, integ, sensor_rec, film_rec, spp_chunk, mesh, seed):
    """Sharded bdpt (reference mesh.py:176-218): sample layers split over
    the ranks, each rank runs whole camera and light subpath chunks, and
    one all-reduce merges both the eye film and the light image.  Returns
    (fn(films, sample_base) -> films, spp_pad)."""
    from mitsuba_tpu_torch.film.film import splat_add
    from mitsuba_tpu_torch.integrator.bdpt import make_bdpt_chunk

    device = mesh.device
    w, h = film_rec.width, film_rec.height
    n_px = w * h
    spp_pad = math.ceil(spp_chunk / mesh.world) * mesh.world
    spp_local = spp_pad // mesh.world
    chunk_fn = make_bdpt_chunk(pack, integ, sensor_rec, w, h, seed)
    layers = (mesh.rank * spp_local
              + torch.arange(spp_local, dtype=torch.int64, device=device)[:, None])
    lane = torch.arange(n_px, dtype=torch.int64, device=device)[None, :].expand(
        spp_local, n_px).reshape(-1)
    layer_ok = (layers < spp_chunk).expand(spp_local, n_px).reshape(-1)

    def render_pass(films, sample_base):
        film, lfilm = films
        sidx = ((sample_base + layers) & _MASK).expand(spp_local, n_px).reshape(-1)
        L, splats = chunk_fn(lane, sidx)
        L = torch.where(layer_ok[..., None], L, 0.0)
        local = torch.zeros(2, h, w, 3, dtype=torch.float32, device=device)
        local[0] = L.reshape(spp_local, h, w, 3).sum(dim=0)
        for pos, val, ok in splats:
            local[1] = splat_add(local[1], pos, val, film_rec.rfilter, valid=ok & layer_ok)
        mesh.all_reduce(local)
        return film + local[0], lfilm + local[1]

    render_pass.stats = chunk_fn.stats
    return render_pass, spp_pad


def _render_sharded_bdpt(scene, pack, mesh, spp, seed):
    from mitsuba_tpu_torch.integrator.bdpt import supports_bdpt
    from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord

    sensor_rec = scene.sensor.record
    film_rec = sensor_rec.film
    w, h = film_rec.width, film_rec.height
    spp = spp or sensor_rec.sampler.sample_count
    if not supports_bdpt(pack):
        print("[bdpt] WARNING: scene outside the bdpt v2 envelope — sharded render falls "
              "back to the path backend")
        saved = scene.integrator
        scene.integrator = IntegratorRecord(kind="path", max_depth=saved.max_depth,
                                            rr_depth=saved.rr_depth)
        try:
            return render_sharded(scene, mesh=mesh, spp=spp, seed=seed)
        finally:
            scene.integrator = saved
    n_px = w * h
    spp_chunk = max(1, min(spp, BDPT_LANES_PER_RANK * mesh.world // n_px))
    n_passes = math.ceil(spp / spp_chunk)
    rp, _ = make_sharded_bdpt_pass(pack, scene.integrator, sensor_rec, film_rec, spp_chunk,
                                   mesh, seed)
    films = (torch.zeros(h, w, 3, dtype=torch.float32, device=mesh.device),
             torch.zeros(h, w, 3, dtype=torch.float32, device=mesh.device))
    done = 0
    for _ in range(n_passes):
        films = rp(films, done)
        done += spp_chunk
    img = films[0] / done + films[1] / (done * n_px)
    return img.cpu().numpy()


# ---------------------------------------------------------------------------
# the photon mappers: eye and photon lanes split
# ---------------------------------------------------------------------------

def _render_sharded_sppm(scene, pack, mesh, spp, seed):
    """Sharded SPPM (reference mesh.py:241-336), also for ppm and the
    photon mapper: the eye lanes (pixels, padded to a multiple of the
    world) and the photon lanes split over the ranks; the visible points
    are all-gathered so that every rank gathers its photons onto the
    whole film, and M, tau and the overflow are all-reduced.  The radius
    and flux progression runs on every rank."""
    from mitsuba_tpu_torch.integrator.sppm import (
        initial_radius,
        make_sppm_passes,
        photons_per_pass_of,
        progress,
        radiance,
    )

    sen = scene.sensor.record
    w, h = sen.film.width, sen.film.height
    n_px = w * h
    device = mesh.device
    if pack.meta["n_emitters"] == 0:
        return np.zeros((h, w, 3), np.float32)
    n_iters = spp or sen.sampler.sample_count
    n_photons = math.ceil(photons_per_pass_of(None, 1 << 18) / mesh.world) * mesh.world
    eye_pass, photon_pass, extent = make_sppm_passes(pack, scene.integrator, sen, w, h, seed,
                                                     device)
    r0 = initial_radius(extent, w, h)
    n_px_pad = math.ceil(n_px / mesh.world) * mesh.world
    lane_px = torch.arange(*mesh.shard(n_px_pad), dtype=torch.int64, device=device)
    lane_ph = torch.arange(*mesh.shard(n_photons), dtype=torch.int64, device=device)
    r2 = torch.full((n_px_pad,), r0 * r0, dtype=torch.float32, device=device)
    N = torch.zeros(n_px_pad, dtype=torch.float32, device=device)
    tau = torch.zeros(n_px_pad, 3, dtype=torch.float32, device=device)
    L_direct = torch.zeros(n_px_pad, 3, dtype=torch.float32, device=device)
    overflow = 0.0
    for it in range(n_iters):
        L_loc, vps_loc = eye_pass(lane_px, it)
        L_i = mesh.all_gather(L_loc)
        vps = tuple(mesh.all_gather(a) for a in vps_loc)
        M, tau_i, dropped = photon_pass(lane_ph, it, vps, r2)
        # M, tau and the overflow share in one all-reduce: rows [M, tau]
        # per visible point, then [overflow, 0, 0, 0]
        last = torch.zeros(1, 4, dtype=torch.float32, device=device)
        last[0, 0] = dropped
        merged = mesh.all_reduce(torch.cat([torch.cat([M[:, None], tau_i], dim=1), last]))
        M, tau_i = merged[:n_px_pad, 0], merged[:n_px_pad, 1:]
        overflow += float(merged[n_px_pad, 0])
        L_direct = L_direct + L_i
        N, tau, r2 = progress(N, tau, r2, M, tau_i)
    if overflow > 0.05 * n_iters:
        print(f"[sppm] per-cell scan window often overflowed ({overflow / n_iters:.2f} mean "
              f"cells/px/pass); gather used unbiased count/K subsampling — variance is "
              f"elevated")
    img = radiance(L_direct, n_iters, tau, r2, n_iters * n_photons)[:n_px]
    return img.reshape(h, w, 3).cpu().numpy()


# ---------------------------------------------------------------------------
# ptracer and vpl
# ---------------------------------------------------------------------------

def _render_sharded_ptracer(scene, pack, mesh, spp, seed):
    """Sharded particle tracer (reference mesh.py:339-373): each batch's
    particle lanes split over the ranks, the films all-reduced."""
    from mitsuba_tpu_torch.integrator.ptracer import BATCH_MAX, make_ptracer_batch

    sen = scene.sensor.record
    w, h = sen.film.width, sen.film.height
    spp = spp or sen.sampler.sample_count
    n_total = spp * w * h
    batch = math.ceil(min(n_total, BATCH_MAX) / mesh.world) * mesh.world
    n_batches = max(n_total // batch, 1)
    run = make_ptracer_batch(pack, scene.integrator, sen, w, h, seed)
    lane = torch.arange(*mesh.shard(batch), dtype=torch.int64, device=mesh.device)
    film = torch.zeros(h, w, 3, dtype=torch.float32, device=mesh.device)
    for b in range(n_batches):
        local, _ = run(torch.zeros_like(film), lane, torch.full_like(lane, b))
        film = film + mesh.all_reduce(local)
    return (film * (1.0 / (n_batches * batch))).cpu().numpy()


def _render_sharded_vpl(scene, pack, mesh, spp, seed):
    """Sharded VPL (reference mesh.py:376-407): the pass ids (each keys
    its own VPL set) split over the ranks, the films all-reduced."""
    from mitsuba_tpu_torch.integrator.vpl import make_vpl_pass

    sen = scene.sensor.record
    w, h = sen.film.width, sen.film.height
    spp = spp or sen.sampler.sample_count
    spp_pad = math.ceil(spp / mesh.world) * mesh.world
    one_pass = make_vpl_pass(pack, scene.integrator, sen, w, h, seed, mesh.device)
    film = torch.zeros(h, w, 3, dtype=torch.float32, device=mesh.device)
    for pass_i in range(*mesh.shard(spp_pad)):
        film = one_pass(film, pass_i)
    return (mesh.all_reduce(film) / spp_pad).cpu().numpy()


_SHARDED_PHOTON_KINDS = ("sppm", "ppm", "photonmapper")
_SHARDED_CHAIN_KINDS = ("pssmlt", "mlt", "erpt")


def render_sharded(scene, mesh=None, spp=None, seed=0, spp_chunk=None):
    """A whole render over the mesh (default: `make_mesh()`, the card);
    every rank returns the developed image, numpy [H, W, 3].

    Every integrator family runs its own algorithm: the path family
    shards sample layers, bdpt its lanes with both films merged, the
    photon mappers their photons, the Metropolis family its chains,
    ptracer its particles and vpl its passes (reference mesh.py:414-477).
    render_sharded.last_ray_count: the rays of the path family's passes
    summed over the ranks (None for the other families)."""
    from mitsuba_tpu_torch.film.film import develop, new_film
    from mitsuba_tpu_torch.scene.builder import pack_scene

    render_sharded.last_ray_count = None
    mesh = mesh or make_mesh()
    pack = pack_scene(scene, mesh.device)
    kind = scene.integrator.kind
    if kind == "bdpt":
        return _render_sharded_bdpt(scene, pack, mesh, spp, seed)
    if kind in _SHARDED_PHOTON_KINDS:
        return _render_sharded_sppm(scene, pack, mesh, spp, seed)
    if kind in _SHARDED_CHAIN_KINDS:
        from mitsuba_tpu_torch.integrator.mlt import render_erpt, render_mlt
        from mitsuba_tpu_torch.integrator.pssmlt import render_pssmlt

        fn = {"pssmlt": render_pssmlt, "mlt": render_mlt, "erpt": render_erpt}[kind]
        return fn(scene, spp=spp, seed=seed, pack=pack, device=mesh.device, mesh=mesh)
    if kind == "ptracer":
        return _render_sharded_ptracer(scene, pack, mesh, spp, seed)
    if kind == "vpl":
        return _render_sharded_vpl(scene, pack, mesh, spp, seed)

    sensor_rec = scene.sensor.record
    film_rec = sensor_rec.film
    w, h = film_rec.width, film_rec.height
    spp = spp or sensor_rec.sampler.sample_count
    if spp_chunk is None:
        spp_chunk = max(1, min(spp, PATH_LANES_PER_RANK * mesh.world // (w * h)))
    n_passes = math.ceil(spp / spp_chunk)
    logger.debug("render_sharded: %dx%d, %d spp (%d passes x %d) on rank %d of %d",
                 w, h, spp, n_passes, spp_chunk, mesh.rank, mesh.world)
    rp = make_sharded_render_pass(pack, scene.integrator, sensor_rec, film_rec,
                                  sensor_rec.sampler, spp_chunk, mesh)
    film = new_film(h, w, mesh.device)
    rays = torch.zeros((), dtype=torch.int64, device=mesh.device)
    for i in range(n_passes):
        film, n_rays = rp(film, i * spp_chunk, seed)
        rays = rays + n_rays
    render_sharded.last_ray_count = int(mesh.all_reduce(rays.reshape(1))[0])
    return (develop(film) * sensor_rec.ray_weight).cpu().numpy()


render_sharded.last_ray_count = None
