#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --first-seed <n> --seeds 12 \
        --controls 3 --seconds 2 [--out <file.jsonl>]

For each of --seeds seeds the cell's driver runs as in a run of the
benchmark (set-up, a window of --seconds, the comparison) in this one
process, and the numbers compared are printed.  Then the control, for
--controls seeds: the plain reference, computed in bfloat16 (the nearest
precision below the float32 the configuration states), put in the
program's place on the same inputs and judged by the same comparison.  A
render's control renders only the pixels the comparison reads, each with
the cell's samples per pixel (pixels are independent, so the rest of the
frame would not change a number).  The benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_render(ctx):
    import torch

    from portbench.lib import compare, scenes
    from portbench.reference.pathtrace import Tracer, render_pixels

    tr = ctx.traffic
    ref = scenes.reference_scene(scenes.scene_xml(ctx.config), tr["width"], tr["height"])
    chk = tr["check"]
    pix = compare.pixel_sample(ref.width, ref.height, chk["pixels"], ctx.seed).to(ctx.dev)
    low = Tracer(ref, ctx.dev, torch.bfloat16)
    gen = torch.Generator(device=ctx.dev).manual_seed(compare.mix(ctx.seed, 0xC0))
    s, _, _ = render_pixels(low, pix, tr["spp"], gen)
    p = (s / tr["spp"]).double().cpu().numpy()
    full = Tracer(ref, ctx.dev, torch.float32)
    _, r, v = render_pixels(full, pix, chk["ref_spp"], compare.reference_generator(ctx.seed,
                                                                                 ctx.dev))
    return compare.render_numbers(p, r.cpu().numpy(), v.cpu().numpy(), tr["spp"], chk["ref_spp"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from portbench import run as harness

    harness.cache_env(ROOT)
    import torch

    from portbench.lib import cells
    from portbench.lib.context import Context

    cell = cells.resolve(cells.benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def context(seed):
        return Context(workload=cell.name, config=cell.config, traffic=cell.traffic,
                       check=cell.check, seed=seed, seconds=args.seconds, trace=False,
                       device="cuda", t_start=time.perf_counter())

    card = torch.cuda.get_device_name(0)
    for i in range(args.seeds):
        seed = args.first_seed + i
        t = time.perf_counter()
        res = cell.driver.run(context(seed))
        emit({"workload": cell.name, "side": "program", "seed": seed, "numbers": res.numbers,
              "attempted": res.attempted, "e2e": res.e2e, "card": card,
              "seconds": time.perf_counter() - t})
    for i in range(args.controls):
        seed = args.first_seed + 1000 + i
        t = time.perf_counter()
        ctx = context(seed)
        numbers = control_render(ctx)
        emit({"workload": cell.name, "side": "control_bf16", "seed": seed, "numbers": numbers,
              "card": card, "seconds": time.perf_counter() - t})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
