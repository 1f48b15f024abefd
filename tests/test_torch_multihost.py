"""Multi-host start-up of the port (mitsuba_tpu_torch/parallel/
multihost.py) on the CPU (tests/test_multihost.py's case).

Two processes on this host join one gloo process group over
tcp://127.0.0.1:<free port> through `init_multihost` and render cbox
(32x32, 4 spp) with `render_multihost`; the image equals one process's
render at tests/test_multihost.py's gate (rtol 1e-5, atol 1e-6: the
counter RNG makes the estimator independent of the split, and only the
film's sums are reassociated).  The CLI with --num-hosts 1 writes the
EXR that `render_to_file` writes (at 1 spp both keep one lane per pixel
and add the same floats).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.io.exr import read_exr
from mitsuba_tpu_torch.parallel.mesh import make_mesh, render_sharded, spawn_ranks
from mitsuba_tpu_torch.renderer import render_to_file
from tests.torch_ranks import CASES, multihost_rank

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_loopback_matches_single_process(tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    spawn_ranks(multihost_rank, 2, (coordinator, str(tmp_path)), 240.0)
    imgs = [np.load(tmp_path / f"rank{r}.npz")["img"] for r in range(2)]
    one = render_sharded(mt.load_scene_string(CASES["path"][0]), mesh=make_mesh(device="cpu"),
                         spp=4)
    assert np.isfinite(imgs[0]).all() and imgs[0].shape == one.shape
    np.testing.assert_array_equal(imgs[1], imgs[0])
    assert np.allclose(one, imgs[0], rtol=1e-5, atol=1e-6), np.abs(one - imgs[0]).max()


def test_cli_one_host_writes_render_to_files_exr(tmp_path):
    xml = tmp_path / "cbox32.xml"
    xml.write_text(CASES["path"][0])
    out = tmp_path / "multihost.exr"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "mitsuba_tpu_torch.parallel.multihost", str(xml), "-o", str(out),
         "--spp", "1", "--num-hosts", "1", "--backend", "gloo", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref_path, _ = render_to_file(mt.load_scene(str(xml)), str(tmp_path / "ref.exr"), spp=1,
                                 device="cpu")
    got, ref = read_exr(str(out))[0], read_exr(ref_path)[0]
    assert got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, ref)
