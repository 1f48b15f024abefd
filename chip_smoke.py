#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mitsuba_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. require a CUDA device, print the card's name and power limit, and
   build the port's kernels from csrc/ with nvcc;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (Cornell-box triangles x 262,144 camera rays) and on
   1,000,000 random rays x 300 random triangles: prim and occlusion must be
   equal and t within 1 ulp; time both (CUDA events, median of 20 runs);
3. render scenes/cbox.xml at 64x64, 16 spp, seed 0 through load_scene ->
   render on the card, check it against tests/golden/cbox_64_16.npy
   (tone-mapped RMSE < 5e-3), and check that the render launched every
   kernel;
4. time a few 512x512 passes of the regenerating wavefront and report
   traced rays per second (closest-hit + shadow rays).

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.  Nothing of JAX is imported.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CBOX = os.path.join(HERE, "scenes", "cbox.xml")
GOLDEN = os.path.join(HERE, "tests", "golden", "cbox_64_16.npy")
KERNEL_SOURCE = "mitsuba_tpu_torch/csrc/brute_hit.cu"
THROUGHPUT_SPP_CHUNK = 16
THROUGHPUT_PASSES = 3


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps=20):
    """Median device time of fn() in ms (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ulp_diff_max(a, b):
    """Largest distance in units of the last place between float32
    tensors of equal sign (0 when equal)."""
    import torch

    check(bool(((a >= 0) == (b >= 0)).all()), "t changes sign between kernel and plain")
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max()) if a.numel() else 0


def compare_kernels(pk, name, o, d, t_max, tri_s, stats):
    """One kernel-vs-plain comparison at one shape; records errors and times."""
    import torch

    if name == "closest_hit_v2":
        t1, p1 = pk.closest_hit_v2(o, d, t_max, tri_s)
        t2, p2 = pk.closest_hit_plain(o, d, t_max, tri_s)
        torch.cuda.synchronize()
        check(torch.equal(p1, p2), f"{name}: prim differs on {int((p1 != p2).sum())} rays")
        ulps = ulp_diff_max(t1, t2)
        check(ulps <= 1, f"{name}: t differs by {ulps} ulp")
        err = float((t1 - t2).abs().max())
        frac = float((p1 >= 0).float().mean())
        kern = lambda: pk.closest_hit_v2(o, d, t_max, tri_s)  # noqa: E731
        plain = lambda: pk.closest_hit_plain(o, d, t_max, tri_s)  # noqa: E731
    else:
        a1 = pk.any_hit_v2(o, d, t_max, tri_s)
        a2 = pk.any_hit_plain(o, d, t_max, tri_s)
        torch.cuda.synchronize()
        check(torch.equal(a1, a2), f"{name}: occlusion differs on {int((a1 != a2).sum())} rays")
        err = float((a1.int() - a2.int()).abs().max())
        frac = float(a1.float().mean())
        kern = lambda: pk.any_hit_v2(o, d, t_max, tri_s)  # noqa: E731
        plain = lambda: pk.any_hit_plain(o, d, t_max, tri_s)  # noqa: E731
    ms, plain_ms = time_ms(kern), time_ms(plain)
    stats.append({
        "name": name, "rays": o.shape[0], "tris": tri_s.shape[1],
        "hit_frac": frac, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    })
    print(f"  {name:15s} rays={o.shape[0]:8d} Tp={tri_s.shape[1]:4d} hit={frac:.3f} "
          f"max|err|={err:g} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch import native
    from mitsuba_tpu_torch.accel import pallas_kernels as pk
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.renderer import make_render_pass
    from mitsuba_tpu_torch.scene.builder import pack_scene
    from mitsuba_tpu_torch.sensor.plugins import generate_rays

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # camera transforms in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- phase 1: build ----
    t0 = time.time()
    lib_path = native.build("brute_hit")
    print(f"phase 1: built {os.path.relpath(lib_path, HERE)} in {time.time() - t0:.2f} s",
          flush=True)

    # ---- phase 2: kernels vs plain on the card ----
    print("phase 2: kernels vs plain versions", flush=True)
    stats = []
    scene = mt.load_scene(CBOX)
    w = h = 512
    scene.sensor.record.film.width = scene.sensor.record.film.height = w
    pack = pack_scene(scene, dev)
    cam = scene.sensor.record.pack(w, h, dev)
    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev, dtype=torch.float32),
        torch.arange(w, device=dev, dtype=torch.float32), indexing="ij",
    )
    pos01 = torch.stack([(xs.reshape(-1) + 0.5) / w, (ys.reshape(-1) + 0.5) / h], -1)
    o, d = generate_rays(cam, pos01, torch.zeros_like(pos01))
    o, d = o.contiguous(), d.contiguous()
    n_cam = o.shape[0]
    compare_kernels(pk, "closest_hit_v2", o, d, torch.full((n_cam,), 1e30, device=dev),
                    pack.tri_s, stats)
    compare_kernels(pk, "any_hit_v2", o, d, torch.full((n_cam,), 1000.0, device=dev),
                    pack.tri_s, stats)

    rng = np.random.default_rng(0)
    n_tri, n_ray = 300, 1_000_000
    v0 = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    e1 = rng.uniform(-0.2, 0.2, (n_tri, 3)).astype(np.float32)
    e2 = rng.uniform(-0.2, 0.2, (n_tri, 3)).astype(np.float32)
    tri_r = torch.as_tensor(pk.pack_triangles_sublane(v0, e1, e2, n_tri), device=dev)
    o_r = torch.as_tensor(rng.uniform(-2, 2, (n_ray, 3)).astype(np.float32), device=dev)
    d_r = rng.normal(size=(n_ray, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    d_r = torch.as_tensor(d_r, device=dev)
    compare_kernels(pk, "closest_hit_v2", o_r, d_r, torch.full((n_ray,), 1e30, device=dev),
                    tri_r, stats)
    compare_kernels(pk, "any_hit_v2", o_r, d_r,
                    torch.as_tensor(rng.uniform(0.2, 3, n_ray).astype(np.float32), device=dev),
                    tri_r, stats)

    # ---- phase 3: the slice on the card, through the kernels ----
    scene64 = mt.load_scene(CBOX)
    scene64.sensor.record.film.width = scene64.sensor.record.film.height = 64
    pk.closest_hit_v2.launches = 0
    pk.any_hit_v2.launches = 0
    t0 = time.time()
    img = mt.render(scene64, spp=16, seed=0, device=dev)
    render_s = time.time() - t0
    launches = {"closest_hit_v2": pk.closest_hit_v2.launches,
                "any_hit_v2": pk.any_hit_v2.launches}
    golden = np.load(GOLDEN)
    check(img.shape == golden.shape, f"image shape {img.shape} != {golden.shape}")
    check(bool(np.isfinite(img).all()), "image has non-finite values")
    rmse = float(np.sqrt(np.mean((img / (1 + img) - golden / (1 + golden)) ** 2)))
    print(f"phase 3: cbox 64x64 16 spp on the card in {render_s:.2f} s: "
          f"tone-mapped RMSE vs golden {rmse:.6g} (gate 5e-3), mean {img.mean():.6f}, "
          f"launches {launches}", flush=True)
    check(rmse < 5e-3, f"golden gate failed: RMSE {rmse}")
    for k, n in launches.items():
        check(n > 0, f"the render never launched {k}")

    # ---- phase 4: throughput, cbox 512x512 ----
    rec = scene.sensor.record
    rp = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler,
                          THROUGHPUT_SPP_CHUNK, dev)
    film = new_film(h, w, dev)
    t0 = time.time()
    film, _ = rp(film, 0, 0)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    total = torch.zeros((), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(THROUGHPUT_PASSES):
        film, n_rays = rp(film, (i + 1) * THROUGHPUT_SPP_CHUNK, 0)
        total = total + n_rays
    n_total = int(total)  # synchronises
    elapsed = time.time() - t0
    check(bool(torch.isfinite(film).all()), "512x512 film has non-finite values")
    rays_s = n_total / elapsed
    print(f"phase 4: cbox 512x512, {THROUGHPUT_PASSES} passes x {THROUGHPUT_SPP_CHUNK} spp: "
          f"{n_total} rays in {elapsed:.3f} s = {rays_s:.6g} rays/s "
          f"(first pass {warm_s:.3f} s) on {card}", flush=True)
    print(json.dumps({"throughput": {
        "scene": "cbox", "width": w, "height": h, "spp_chunk": THROUGHPUT_SPP_CHUNK,
        "passes": THROUGHPUT_PASSES, "rays": n_total, "seconds": elapsed,
        "rays_per_s": rays_s, "card": card,
    }}), flush=True)

    main_shape = {s["name"]: s for s in stats[:2]}
    kernels = []
    for name, line in (("closest_hit_v2", 434), ("any_hit_v2", 445)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": f"mitsuba_tpu/accel/pallas_kernels.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in stats if s["name"] == name),
            "ms": main_shape[name]["ms"],
            "plain_ms": main_shape[name]["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
