#!/usr/bin/env python3
"""Time the port's brute-force wrappers on one NVIDIA GPU.

    python3 time_brute.py [TREE]

TREE (default: this script's directory) is the root of a checkout of the
repository whose package `mitsuba_tpu_torch` is timed, so that two trees
(a change and its parent) can be timed in one run on one card.  Shapes:
the Cornell box's triangles against its 262,144 camera rays (512x512,
pixel centres), 1,000,000 random rays against 300 random triangles, and
262,144 random rays against 1,000 (Tp = 1,024: past one staged chunk of
512).  Wrappers: K1/K2 (`closest_hit_v2` / `any_hit_v2`) on the sublane
pack tri_s, K11 (`closest_hit` / `any_hit`) on the transposed pack tri_t,
K12 (`closest_hit_mxu` / `any_hit_mxu`) on build_mt_matrix's operand;
closest hits with t_max inf, occlusion with chip_smoke.py's t_max (1,000
on camera rays, uniform in [0.2, 3] on random rays), plus K12's occlusion
on camera shadow rays of which half have t_max NaN (as in a render pass,
where paths that left the scene trace no shadow ray).  Each line: the
median of 20 calls between CUDA events with the host's launch work
inside, and on the card alone (chip_smoke.py's `time_ms`), every wrapper
in turn and then again in reverse order.
Beside them, the product of K12's bilinear form alone on the tensor cores:
one `torch.matmul` in TF32 of the [R, 16] features by the [16, 4 Tp]
operand, its [R, 4 Tp] float32 written out (no epilogue; not bit-equal to
the float32 kernel, so a yardstick only, not a design of the port).  The
first line is the card's name and power limit.  K11 is checked equal to
K1/K2 on each shape.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_brute: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    sys.path.append(os.path.join(root, "tests"))
    import chip_smoke as cs
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.accel import pallas_kernels as pk
    from mitsuba_tpu_torch.scene.builder import pack_scene

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; tree {root}", flush=True)
    scene = mt.load_scene(os.path.join(root, "scenes", "cbox.xml"))
    scene.sensor.record.film.width = scene.sensor.record.film.height = 512
    pack = pack_scene(scene, dev)
    o, d = cs.camera_rays(scene, dev)
    n_box = int((pack.tri_t[0] < cs.FAR_V0).sum())
    box = [pack.arrays[k][:n_box].cpu().numpy() for k in ("tri_v0", "tri_e1", "tri_e2")]
    sets = [("cbox camera", o, d, torch.full((o.shape[0],), 1000.0, device=dev), pack.tri_s,
             pack.tri_t, torch.as_tensor(pk.build_mt_matrix(*box, n_box), device=dev))]
    rng = np.random.default_rng(0)
    for n_tri, n_ray in ((300, 1_000_000), (1000, 262_144)):
        v0 = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
        e1 = rng.uniform(-0.2, 0.2, (n_tri, 3)).astype(np.float32)
        e2 = rng.uniform(-0.2, 0.2, (n_tri, 3)).astype(np.float32)
        o_r = torch.as_tensor(rng.uniform(-2, 2, (n_ray, 3)).astype(np.float32), device=dev)
        d_r = rng.normal(size=(n_ray, 3)).astype(np.float32)
        d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
        sets.append((f"random {n_ray} x {n_tri}", o_r, torch.as_tensor(d_r, device=dev),
                     torch.as_tensor(rng.uniform(0.2, 3, n_ray).astype(np.float32), device=dev),
                     torch.as_tensor(pk.pack_triangles_sublane(v0, e1, e2, n_tri), device=dev),
                     torch.as_tensor(pk.pack_triangles_transposed(v0, e1, e2, n_tri),
                                     device=dev).contiguous(),
                     torch.as_tensor(pk.build_mt_matrix(v0, e1, e2, n_tri), device=dev)))
    for label, o, d, t_any, tri_s, tri_t, mtm in sets:
        t_inf = torch.full_like(t_any, float("inf"))
        a, b = pk.closest_hit(o, d, t_inf, tri_t), pk.closest_hit_v2(o, d, t_inf, tri_s)
        cs.check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), "K11 differs from K1")
        cs.check(torch.equal(pk.any_hit(o, d, t_any, tri_t), pk.any_hit_v2(o, d, t_any, tri_s)),
                 "K11 differs from K2")
        runs = [("closest_hit_v2 (K1)", lambda: pk.closest_hit_v2(o, d, t_inf, tri_s)),
                ("any_hit_v2 (K2)", lambda: pk.any_hit_v2(o, d, t_any, tri_s)),
                ("closest_hit (K11)", lambda: pk.closest_hit(o, d, t_inf, tri_t)),
                ("any_hit (K11)", lambda: pk.any_hit(o, d, t_any, tri_t)),
                ("closest_hit_mxu (K12)", lambda: pk.closest_hit_mxu(o, d, t_inf, mtm)),
                ("any_hit_mxu (K12)", lambda: pk.any_hit_mxu(o, d, t_any, mtm))]
        if label == "cbox camera":
            t_half = t_any.clone()
            t_half[::2] = float("nan")
            runs.append(("any_hit_mxu half NaN", lambda: pk.any_hit_mxu(o, d, t_half, mtm)))
        print(f"{label}: Tp = {tri_t.shape[1]}", flush=True)
        for name, fn in runs + runs[::-1]:
            print(f"  {name:24s} {cs.time_ms(fn):.4f} ms, card alone "
                  f"{cs.time_ms(fn, card_only=True):.4f}", flush=True)
        feat = pk.ray_features(o, d)
        torch.backends.cuda.matmul.allow_tf32 = True
        ms = cs.time_ms(lambda: torch.matmul(feat, mtm), card_only=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"  {'matmul TF32 (product)':24s} card alone {ms:.4f} ms, "
              f"[{o.shape[0]}, 16] x {tuple(mtm.shape)}", flush=True)
    print("time_brute: done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
