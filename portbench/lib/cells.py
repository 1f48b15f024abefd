"""Find a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
Everything else is found by name, so a new cell is new files and entries:

* configs/<config>.json (the file BENCHMARK.json gives), with the scene
  XML it names beside it;
* traffic/<traffic>.json, which names its driver;
* drivers/<driver>.py, one for each way a window drives the program;
* checks/<workload>.json, the limits that decide `correct`;
* metrics/<metric>.py, one reader for each per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HARNESS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HARNESS_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file, with "dir" (its folder) added
    traffic: dict
    check: dict
    driver: object  # the driver module
    end_to_end: list  # BENCHMARK.json's end-to-end entries this cell reports
    per_layer: list  # (entry, reader module) of the per-layer metrics this cell reports


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root=ROOT):
    return read_json(os.path.join(root, "BENCHMARK.json"))


def reports(entry, workload):
    """Whether a metric entry is reported in `workload`: listed there, or
    listing no cells."""
    return "workloads" not in entry or workload in entry["workloads"]


def resolve(bench, workload, root=ROOT):
    """The Cell of `workload`; raises KeyError naming what is missing."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"workload {workload!r} is not in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_path = os.path.join(root, configs[w["config"]]["file"])
    config = read_json(cfg_path)
    config["dir"] = os.path.dirname(cfg_path)
    traffic = read_json(os.path.join(HARNESS_DIR, "traffic", w["traffic"] + ".json"))
    check = read_json(os.path.join(HARNESS_DIR, "checks", workload + ".json"))
    driver = load_module(os.path.join(HARNESS_DIR, "drivers", traffic["driver"] + ".py"),
                         "portbench_driver_" + traffic["driver"])
    per_layer = [
        (m, load_module(os.path.join(HARNESS_DIR, "metrics", m["name"] + ".py"),
                        "portbench_metric_" + m["name"].replace(".", "_")))
        for m in bench["per_layer"] if reports(m, workload)
    ]
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    return Cell(workload, w["chips"], config, traffic, check, driver, e2e, per_layer)
