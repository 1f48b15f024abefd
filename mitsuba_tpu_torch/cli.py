"""Command-line frontend (port of mitsuba_tpu/cli.py).

Rebuild of the `mitsuba` CLI (reference: src/mitsuba/mitsuba.cpp:129-418):
scene XML in, rendered image out, with -D parameter substitution, -o
output override, -s spp override, quiet/verbose logging, and benchmark
style statistics at exit (= Statistics::printStats, mitsuba.cpp:409).

Usage:
    python -m mitsuba_tpu_torch scene.xml [scene2.xml ...]
    python -m mitsuba_tpu_torch -D spp=64 -o out.exr scene.xml

It renders on the card; `--cpu` asks for the CPU.  Without a card and
without `--cpu` it stops with an error.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="mitsuba_tpu_torch",
        description="physically based renderer on an NVIDIA GPU "
        "(Mitsuba-compatible scene format)",
    )
    p.add_argument("scenes", nargs="+", help="scene XML file(s)")
    p.add_argument("-o", "--output", help="output image path")
    p.add_argument(
        "-D",
        dest="defines",
        action="append",
        default=[],
        metavar="key=value",
        help="define a scene parameter ($key substitution)",
    )
    p.add_argument(
        "-s", "--spp", type=int, help="override samples per pixel"
    )
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument(
        "-x",
        "--skip-existing",
        action="store_true",
        help="skip scenes whose output already exists (reference -x flag)",
    )
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument(
        "--size", metavar="WxH", help="override film resolution"
    )
    p.add_argument(
        "--cpu",
        action="store_true",
        help="render on the CPU instead of the card (debugging)",
    )
    p.add_argument(
        "--pack-cache",
        action="store_true",
        help="cache the packed scene next to the XML (<scene>.mtspack) "
             "and reuse it on later runs — skips parsing, BVH/cluster "
             "builds, and texture packing (the serialized-scene role, "
             "reference serialization.h)",
    )
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mitsuba_tpu_torch: no CUDA device; pass --cpu to render on the CPU")

    defaults = {}
    for d in args.defines:
        if "=" not in d:
            raise SystemExit(f"-D expects key=value, got '{d}'")
        k, v = d.split("=", 1)
        defaults[k] = v

    from mitsuba_tpu_torch.renderer import render_to_file
    from mitsuba_tpu_torch.scene.xml_loader import load_scene

    for path in args.scenes:
        scene = load_scene(path, defaults=dict(defaults))
        film = scene.sensor.record.film
        if args.size:
            w, h = args.size.lower().split("x")
            film.width, film.height = int(w), int(h)
        output = args.output
        if output is None:
            output = (
                os.path.splitext(path)[0] + film.output_extension()
            )
        if args.skip_existing and os.path.exists(output):
            if not args.quiet:
                print(f"* skipping {path} (output exists)")
            continue
        spp = args.spp or scene.sensor.record.sampler.sample_count
        if not args.quiet:
            print(
                f"* rendering {path}: {film.width}x{film.height} @ {spp}spp "
                f"({scene.integrator.kind})"
            )
        t0 = time.time()

        pack = None
        if args.pack_cache and args.size:
            print("  (pack cache skipped: --size overrides the scene)")
        elif args.pack_cache:
            from mitsuba_tpu_torch.scene.builder import pack_scene
            from mitsuba_tpu_torch.scene.serialize import load_pack, save_pack

            cache = os.path.splitext(path)[0] + ".mtspack"
            fresh = os.path.exists(cache) and (
                os.path.getmtime(cache) >= os.path.getmtime(path)
            )
            if fresh:
                pack = load_pack(cache, device=device)
                if not args.quiet:
                    print(f"  (pack cache hit: {cache})")
            else:
                pack = pack_scene(scene, device)
                save_pack(pack, cache)
                if not args.quiet:
                    print(f"  (pack cached: {cache})")

        def progress(i, n):
            if not args.quiet:
                pct = 100.0 * i / n
                sys.stdout.write(f"\r  pass {i}/{n} ({pct:.0f}%)")
                sys.stdout.flush()

        out, img = render_to_file(
            scene, output=output, spp=spp, seed=args.seed,
            progress=progress, pack=pack, device=device,
        )
        dt = time.time() - t0
        if not args.quiet:
            n_rays = film.width * film.height * spp
            print(
                f"\n  wrote {out} in {dt:.2f}s "
                f"({n_rays / dt / 1e6:.2f} Msamples/s)"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
