#!/usr/bin/env python3
"""The benchmark of mitsuba_tpu_torch, one cell a run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell (an entry of BENCHMARK.json's
`workloads`) names a configuration and a traffic mix; the traffic names
the driver that runs the window (drivers/<driver>.py).  The run makes its
inputs from --seed, warms up the cell's own shapes, measures for
--seconds, then checks what the window produced against the plain
reference (checks/<workload>.json holds the limits).  It prints each
number compared beside its limit as the last lines of standard error,
and one JSON line as the last line of standard output: with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer metrics (each
read by metrics/<metric>.py from the traced run), the device's busy and
window seconds and a breakdown.

It exits with 2 and prints no result when the card, or as many cards as
the cell asks for, is missing, and with 3 when a module of JAX or of the
JAX package was loaded.  The program's kernel caches stay inside the
checkout (build/), at fixed paths.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "mitsuba_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_env(root):
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port itself builds into <root>/build/kernels and build/native."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(cell, seed, seconds, trace, device, t_start):
    """Run `cell` on `device`: (the result line's object, [(name, value,
    limit)] of the numbers compared)."""
    import torch

    from portbench.lib import compare
    from portbench.lib import trace as dtrace
    from portbench.lib.context import Context

    ctx = Context(workload=cell.name, config=cell.config, traffic=cell.traffic,
                  check=cell.check, seed=seed, seconds=seconds, trace=bool(trace),
                  device=device, t_start=t_start)
    out = cell.driver.run(ctx)
    ok, lines = compare.judge(out.numbers, cell.check["limits"])
    on_card = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": out.device_count, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": bool(ok and out.failed == 0), "attempted": out.attempted,
              "failed": out.failed}
    if trace:
        facts = dict(out.facts, card=kind)
        if "device" not in facts:
            facts["device"] = dtrace.reduce(ctx.dtrace.results)
        metrics = {}
        for entry, reader in cell.per_layer:
            v = reader.read(facts)
            if v is not None:
                metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
        result["metrics"] = metrics
        if facts["device"]:
            dev["busy_s"] = facts["device"]["busy_s"]
            dev["window_s"] = facts["device"]["window_s"]
            result["breakdown"] = {"device_ops": facts["device"]["device_ops_top"],
                                   "idle_gaps": facts["device"]["idle_gaps_top"]}
    else:
        result["metrics"] = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = dev
    # a number that is not finite (a NaN in an image) prints as null
    result["check"] = {n: {"value": v if math.isfinite(v) else None, "limit": lim}
                       for n, v, lim in lines}
    return result, lines


def main(argv=None):
    args = parse(argv)
    cache_env(ROOT)
    from portbench.lib import cells

    cell = cells.resolve(cells.benchmark(ROOT), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), {n} visible",
              file=sys.stderr)
        return 2
    result, lines = execute(cell, args.seed, args.seconds, args.trace, "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, value, limit in lines:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
