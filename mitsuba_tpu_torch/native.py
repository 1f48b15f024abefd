"""Build and load the port's hand-written CUDA kernels.

Each kernel source under `csrc/` exposes a plain C interface.  At first
use it is compiled with `nvcc` for Hopper (`sm_90a`) into a shared
library under `<repo>/build/kernels/<name>-<source hash>/` and loaded
with `ctypes`; later calls in the process reuse the loaded library, and
later processes reuse the file while the source is unchanged.  Nothing
is built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

# Bit-comparable arithmetic with the plain PyTorch versions: no fused
# multiply-add contraction, IEEE division and square root.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are compiled at first use"
    )


def _source_hash(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    return os.path.join(
        BUILD_DIR, f"{name}-{_source_hash(src)}", f"lib{name}.so"
    )


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is already built;
    returns the library path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = library_path(name)
    if os.path.isfile(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(name: str, declare) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, cached per process.
    `declare(lib)` runs once after loading, to set argtypes/restype."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            declare(lib)
            _loaded[name] = lib
        return lib
