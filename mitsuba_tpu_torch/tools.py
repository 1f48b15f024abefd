"""Utility launcher: the `mtsutil` equivalent (port of mitsuba_tpu/tools.py).

Rebuild of reference src/mitsuba/mtsutil.cpp + src/utils/*:
* tonemap    — batch HDR->LDR conversion (utils/tonemap.cpp:443)
* addimages  — weighted sum of two images (utils/addimages.cpp)
* joinrgb    — merge three single-channel images (utils/joinrgb.cpp)
* kdbench    — ray-throughput benchmark on a scene (utils/kdbench.cpp:30),
               on the card unless `--cpu` asks for the CPU
* rdielprec  — rough-dielectric transmittance tables (utils/rdielprec.cpp)
* cylclip    — the clipped-cylinder bounds self-test (utils/cylclip.cpp)

Usage: python -m mitsuba_tpu_torch.tools <command> [args...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def tonemap(argv):
    p = argparse.ArgumentParser(prog="tonemap")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", help="output (single input only)")
    p.add_argument("-m", "--multiplier", type=float, default=1.0)
    p.add_argument("-g", "--gamma", type=float, default=-1.0,
                   help="-1 = sRGB curve")
    p.add_argument("-t", "--tonemap", choices=["gamma", "reinhard"],
                   default="gamma")
    p.add_argument("-k", "--key", type=float, default=0.18)
    p.add_argument("-f", "--format", default="png")
    args = p.parse_args(argv)

    from mitsuba_tpu_torch.film.plugins import FilmRecord
    from mitsuba_tpu_torch.io.images import read_image, write_image

    for path in args.inputs:
        img, is_ldr = read_image(path)
        img = img[..., :3] * args.multiplier
        rec = FilmRecord(
            is_ldr=True, tonemap=args.tonemap, gamma=args.gamma,
            key=args.key,
        )
        out = rec.develop_to_array(img)
        dst = args.output or os.path.splitext(path)[0] + "." + args.format
        write_image(dst, out)
        print(f"tonemap: {path} -> {dst}")


def addimages(argv):
    p = argparse.ArgumentParser(prog="addimages")
    p.add_argument("weight_a", type=float)
    p.add_argument("image_a")
    p.add_argument("weight_b", type=float)
    p.add_argument("image_b")
    p.add_argument("output")
    args = p.parse_args(argv)
    from mitsuba_tpu_torch.io.images import read_image, write_image

    a, _ = read_image(args.image_a)
    b, _ = read_image(args.image_b)
    write_image(args.output, args.weight_a * a + args.weight_b * b)
    print(f"addimages: wrote {args.output}")


def joinrgb(argv):
    p = argparse.ArgumentParser(prog="joinrgb")
    p.add_argument("red")
    p.add_argument("green")
    p.add_argument("blue")
    p.add_argument("output")
    args = p.parse_args(argv)
    from mitsuba_tpu_torch.io.images import read_image, write_image

    chans = [read_image(x)[0][..., 0] for x in (args.red, args.green, args.blue)]
    write_image(args.output, np.stack(chans, axis=-1))
    print(f"joinrgb: wrote {args.output}")


def kdbench(argv):
    """Incoherent ray throughput on a scene's geometry — the equivalent
    of the reference's kdbench sphere-to-sphere benchmark
    (utils/kdbench.cpp:221-242, test_kd.cpp:102-130): closest hits of
    `intersect` on the card (CUDA events around each call after a
    warm-up; `--cpu`: the CPU and the host's clock), best of
    `--best-of`.  A second line gives the launches of each kernel over
    the timed calls."""
    p = argparse.ArgumentParser(prog="kdbench")
    p.add_argument("scene")
    p.add_argument("-n", "--rays", type=int, default=10_000_000)
    p.add_argument("--best-of", type=int, default=3)
    p.add_argument("--coherent", action="store_true",
                   help="scanline pinhole rays instead of random "
                        "sphere-to-sphere")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    import torch

    from mitsuba_tpu_torch.accel.intersect import intersect
    from mitsuba_tpu_torch.core import rng, warp
    from mitsuba_tpu_torch.scene.builder import pack_scene
    from mitsuba_tpu_torch.scene.xml_loader import load_scene

    dev = torch.device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("kdbench: no CUDA device; pass --cpu to run on the CPU")
    scene = load_scene(args.scene)
    pack = pack_scene(scene, dev)

    v0 = pack.tri_v0[: pack.n_tris].cpu().numpy()
    lo, hi = v0.min(axis=0), v0.max(axis=0)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo) / 2 * 1.3)

    n = args.rays
    if args.coherent:
        # scanline-ordered primary rays from a virtual pinhole — the
        # packet-friendly case (reference kdbench's "coherent" variant)
        side = int(np.sqrt(n))
        n = side * side
        i = torch.arange(n, dtype=torch.float32, device=dev)
        px = (i % side + 0.5) / side
        py = (torch.div(i, side, rounding_mode="floor") + 0.5) / side
        eye = torch.as_tensor(center + np.array([0.0, 0.25 * radius, -2.2 * radius]),
                              dtype=torch.float32, device=dev)
        span = 1.15 * radius
        target = torch.stack([
            float(center[0]) + (px - 0.5) * 2 * span,
            float(center[1]) + (py - 0.5) * 2 * span,
            torch.full((n,), float(center[2]), dtype=torch.float32, device=dev),
        ], dim=-1)
        p1 = eye[None, :].expand(n, 3).contiguous()
    else:
        # random sphere-to-sphere rays around the scene bounds
        u = rng.rand4(torch.arange(n, dtype=torch.int64, device=dev), 0, 0)
        c = torch.as_tensor(center, dtype=torch.float32, device=dev)
        p1 = warp.square_to_uniform_sphere(u[..., 0:2]) * radius + c
        target = warp.square_to_uniform_sphere(u[..., 2:4]) * radius + c
    d = target - p1
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    sort = pack.use_bvh and not args.coherent

    wrappers = _kernel_wrappers()
    intersect(pack, p1, d, sort=sort)  # warm-up: builds the kernels
    for fn in wrappers.values():
        fn.launches = 0
    best = np.inf
    for _ in range(args.best_of):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            intersect(pack, p1, d, sort=sort)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            intersect(pack, p1, d, sort=sort)
            best = min(best, time.perf_counter() - t0)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(
        f"kdbench: {n/best/1e6:.2f} MRays/s "
        f"({pack.n_tris} tris, {'BVH' if pack.use_bvh else 'brute'}, "
        f"{'coherent' if args.coherent else 'incoherent'}, "
        f"best of {args.best_of}) on {where}"
    )
    print(f"kdbench: launches {({k: fn.launches for k, fn in wrappers.items() if fn.launches})}")


def _kernel_wrappers():
    """Every kernel wrapper of the port by name, each counting its
    launches in `.launches`."""
    from mitsuba_tpu_torch.accel import pairs, pallas_bvh, pallas_kernels

    return {name: fn for mod in (pallas_kernels, pairs, pallas_bvh)
            for name, fn in vars(mod).items()
            if callable(fn) and hasattr(fn, "launches") and fn.__module__ == mod.__name__}


def rdielprec(argv):
    """Precompute rough-dielectric transmittance tables (reference
    src/utils/rdielprec.cpp, which generates the data/microfacet/*.dat
    splines).  Here the tables are MC-integrated on an (alpha, cos)
    grid for one eta and written as .npz, with the polynomial fit the
    renderer actually consumes (bsdf/rtrans.py) printed alongside."""
    p = argparse.ArgumentParser(prog="rdielprec")
    p.add_argument("-o", "--output", default="rtrans.npz")
    p.add_argument("--eta", type=float, default=1.5)
    p.add_argument("--dist", default="ggx", choices=["ggx", "beckmann"])
    p.add_argument("--n-alpha", type=int, default=16)
    p.add_argument("--n-cos", type=int, default=32)
    p.add_argument("--samples", type=int, default=8192)
    a = p.parse_args(argv)

    from mitsuba_tpu_torch.bsdf.rtrans import rough_transmittance

    alphas = np.linspace(0.05, 1.0, a.n_alpha)
    coss = np.linspace(0.02, 1.0, a.n_cos)
    tbl = np.zeros((a.n_alpha, a.n_cos), np.float32)
    for i, al in enumerate(alphas):
        tbl[i] = np.asarray(
            rough_transmittance(
                a.dist, float(al), a.eta, coss, n_samples=a.samples
            )
        )
    np.savez(a.output, alphas=alphas, cosines=coss, T=tbl,
             eta=a.eta, dist=a.dist)
    print(
        f"rdielprec: {a.dist} eta={a.eta} -> {a.output} "
        f"[{a.n_alpha}x{a.n_cos}], T range "
        f"[{tbl.min():.4f}, {tbl.max():.4f}]"
    )


def cylclip(argv):
    """Cylinder/AABB clipping self-test (reference src/utils/
    cylclip.cpp, the dev check for the hair kd-tree's clipped cylinder
    bounds).  Computes the tight AABB of a cylinder clipped to a box
    analytically (endpoint discs + axis clamping) and validates it
    against dense surface sampling."""
    p = argparse.ArgumentParser(prog="cylclip")
    p.add_argument("--trials", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    rng = np.random.default_rng(a.seed)
    worst = 0.0
    fails = 0
    for _ in range(a.trials):
        p0 = rng.uniform(-1, 1, 3)
        p1 = rng.uniform(-1, 1, 3)
        rad = rng.uniform(0.02, 0.4)
        blo = rng.uniform(-0.8, 0.0, 3)
        bhi = blo + rng.uniform(0.4, 1.6, 3)
        lo, hi = cyl_clip_aabb(p0, p1, rad, blo, bhi)
        # dense sampling of the cylinder surface clipped to the box
        t = rng.uniform(0, 1, (4096, 1))
        ax = p1 - p0
        n1 = np.cross(ax, [0.12, 0.87, 0.43])
        n1 /= max(np.linalg.norm(n1), 1e-12)
        n2 = np.cross(ax, n1)
        n2 /= max(np.linalg.norm(n2), 1e-12)
        ph = rng.uniform(0, 2 * np.pi, (4096, 1))
        pts = (
            p0 + t * ax + rad * (np.cos(ph) * n1 + np.sin(ph) * n2)
        )
        inside = np.all((pts >= blo) & (pts <= bhi), axis=-1)
        if not inside.any():
            continue
        smp_lo = pts[inside].min(axis=0)
        smp_hi = pts[inside].max(axis=0)
        if (smp_lo < lo - 1e-9).any() or (smp_hi > hi + 1e-9).any():
            fails += 1
        worst = max(
            worst,
            float(np.max((hi - lo) - np.maximum(smp_hi - smp_lo, 0))),
        )
    print(
        f"cylclip: {a.trials} trials, {fails} containment failures, "
        f"worst bound slack {worst:.4f}"
    )
    return fails


def cyl_clip_aabb(p0, p1, radius, blo, bhi):
    """Tight conservative AABB of a cylinder clipped to a box: clamp
    the axis span to the box (expanded by the radius), then pad each
    axis by the cylinder's cross-section extent
    r * sqrt(1 - axis_dir^2) (the exact per-axis extent of a disc)."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    ax = p1 - p0
    ln = np.linalg.norm(ax)
    ad = ax / max(ln, 1e-12)
    disc = radius * np.sqrt(np.maximum(1.0 - ad * ad, 0.0))
    # clip the axis segment's t-range against the radius-expanded box
    t0, t1 = 0.0, 1.0
    for k in range(3):
        lo_k = blo[k] - disc[k]
        hi_k = bhi[k] + disc[k]
        if abs(ax[k]) < 1e-12:
            if p0[k] < lo_k or p0[k] > hi_k:
                return np.full(3, 1e30), np.full(3, -1e30)
            continue
        ta = (lo_k - p0[k]) / ax[k]
        tb = (hi_k - p0[k]) / ax[k]
        t0 = max(t0, min(ta, tb))
        t1 = min(t1, max(ta, tb))
    if t0 > t1:
        return np.full(3, 1e30), np.full(3, -1e30)
    a = p0 + t0 * ax
    b = p0 + t1 * ax
    lo = np.minimum(a, b) - disc
    hi = np.maximum(a, b) + disc
    return np.maximum(lo, blo - 1e-12), np.minimum(hi, bhi + 1e-12)


COMMANDS = {
    "tonemap": tonemap,
    "addimages": addimages,
    "joinrgb": joinrgb,
    "kdbench": kdbench,
    "rdielprec": rdielprec,
    "cylclip": cylclip,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        print(
            "usage: python -m mitsuba_tpu_torch.tools "
            f"{{{','.join(COMMANDS)}}} [args...]",
            file=sys.stderr,
        )
        return 1
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
