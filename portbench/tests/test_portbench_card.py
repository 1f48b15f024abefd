"""Each cell run end to end on the card as the benchmark's command runs it,
with a short window: the result line keeps to its format, and the run is
correct.  Skipped where the card, or as many cards as the cell asks for,
is missing."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.lib import cells

pytestmark = pytest.mark.cuda

BENCH = cells.benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
SEED = 2_200_000_321  # past 2**31: a seed may exceed 32 signed bits


def _run(workload, trace):
    cell = cells.resolve(BENCH, workload)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell.chips:
        pytest.skip(f"{workload} needs {cell.chips} CUDA card(s), {n} visible")
    cmd = [sys.executable, os.path.join(cells.HARNESS_DIR, "run.py"), "--workload", workload,
           "--seed", str(SEED), "--seconds", "2", "--trace", str(trace)]
    p = subprocess.run(cmd, cwd=cells.ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "check"
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, result
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == cell.chips
    assert dev["kind"] == torch.cuda.get_device_name(0) and dev["memory_peak_bytes"] > 0
    return cell, result


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_card(workload):
    cell, result = _run(workload, 0)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = result["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_cell_on_card(workload):
    cell, result = _run(workload, 1)
    # every per-layer metric listed for the cell finds something to read
    assert set(result["metrics"]) == {e["name"] for e, _ in cell.per_layer}
    for entry, _ in cell.per_layer:
        got = result["metrics"][entry["name"]]
        assert got["unit"] == entry["unit"]
        if entry["unit"] == "%":
            assert 0.0 <= got["value"] <= 100.0, (entry["name"], got)
    dev = result["device"]
    assert 0.0 < dev["busy_s"] <= dev["window_s"]
    for key in ("device_ops", "idle_gaps"):
        assert 0 < len(result["breakdown"][key]) <= 10
