"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import ast
import json
import os
import re

import pytest

from portbench.lib import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "mitsuba_tpu"}
# what the benchmark may not read: the JAX package's harness and the tests
FOREIGN = {"bench", "bench_rmse", "chip_smoke", "profile_pass", "time_brute",
           "sharded_scaling", "tests", "torch_meshes", "bench_refs"}


def _py_files():
    for d, _, files in os.walk(cells.HARNESS_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(workload):
    cell = cells.resolve(BENCH, workload)
    assert callable(cell.driver.run)
    assert cell.check["limits"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for entry, reader in cell.per_layer:
        assert callable(reader.read)
        assert entry["moves"] in names


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_metric_files_match_benchmark():
    for m in BENCH["per_layer"]:
        mod = cells.load_module(os.path.join(cells.HARNESS_DIR, "metrics", m["name"] + ".py"),
                                "m_" + m["name"].replace(".", "_"))
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"])


def test_configs_files():
    for c in BENCH["configs"]:
        path = os.path.join(cells.ROOT, c["file"])
        assert path.startswith(cells.HARNESS_DIR + os.sep)
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert os.path.exists(os.path.join(os.path.dirname(path), cfg["scene"]))


def test_no_jax_and_no_foreign_imports():
    for path in _py_files():
        found = set(_imports(path))
        assert not found & FORBIDDEN, (path, found & FORBIDDEN)
        assert not found & FOREIGN, (path, found & FOREIGN)
        if os.sep + "reference" + os.sep in path:
            assert "mitsuba_tpu_torch" not in found, path
