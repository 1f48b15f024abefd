"""Build and load the port's native code.

* CUDA kernels: each source under `csrc/` exposes a plain C interface.
  At first use it is compiled with `nvcc` for Hopper (`sm_90a`) into a
  shared library under `<repo>/build/kernels/<name>-<source hash>/` and
  loaded with `ctypes`.
* Host libraries: the port's copy of the reference's C++ BVH builder
  (`csrc/host/bvh_builder.cpp`) is compiled with `g++` and the
  reference's flags into `<repo>/build/native/`, so that the port builds
  the same tree as the reference from its own source.

Later calls in the process reuse a loaded library, and later processes
reuse the file while the source is unchanged.  Nothing is built or
loaded when the module is imported.  `check_tensors` and `launch` are the
kernel wrappers' shared argument check and launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import re
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_DIR = os.path.dirname(_PKG_DIR)
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_REPO_DIR, "build", "kernels")
HOST_BUILD_DIR = os.path.join(_REPO_DIR, "build", "native")
# the port's host sources and the reference's g++ flags
# (mitsuba_tpu/native/__init__.py _build)
HOST_SRC_DIR = os.path.join(CSRC_DIR, "host")
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native")

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


def _source_hash(path: str, flags, extra: str = "", headers=()) -> str:
    h = hashlib.sha256()
    for p in (path, *headers):
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(extra.encode())
    return h.hexdigest()[:16]


def _host_cpu() -> str:
    """The CPU a -march=native build targets: its model and feature flags,
    so that a build directory copied to another machine is not reused."""
    try:
        with open("/proc/cpuinfo") as f:
            info = [ln for ln in f if ln.startswith(("model name", "flags"))][:2]
    except OSError:
        info = []
    return platform.machine() + "".join(info)


def library_path(name: str) -> str:
    """Where csrc/<name>.cu is built: keyed on the source, the headers
    beside it and the flags."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    return os.path.join(
        BUILD_DIR, f"{name}-{_source_hash(src, NVCC_FLAGS, headers=headers)}",
        f"lib{name}.so",
    )


def _compile(cmd_head, src, out, what):
    """Run `cmd_head -o <tmp> src` and move the result to `out`."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd_head, "-o", tmp, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{what} failed for {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is already built;
    returns the library path."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    return _compile([find_nvcc(), *NVCC_FLAGS], src, out, "nvcc")


def resource_usage(name: str) -> dict:
    """Compile csrc/<name>.cu once more with `-Xptxas -v` (into a
    temporary library that is deleted) and return ptxas's report per
    kernel: {mangled name: {"registers", "stack", "spill_stores",
    "spill_loads"}} in bytes, registers as a count."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{name}-usage.{os.getpid()}.so")
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", out, src],
                              capture_output=True, text=True)
    finally:
        if os.path.exists(out):
            os.remove(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed for {src}:\n{proc.stderr}")
    report, fn = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn is not None:
            report[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            report[fn]["registers"] = int(m.group(1))
    return report


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


def load_host(name: str, source: str, declare) -> ctypes.CDLL | None:
    """Build (if needed) and load the host source csrc/host/<source>
    as build/native/<name>-<hash>/lib<name>.so,
    cached per process.  Returns None when no C++ compiler can build it
    (the caller then takes its numpy fallback, as the reference does)."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = os.path.join(HOST_SRC_DIR, source)
        out = os.path.join(
            HOST_BUILD_DIR, f"{name}-{_source_hash(src, HOST_CXX_FLAGS, _host_cpu())}",
            f"lib{name}.so",
        )
        lib = None
        cxx = shutil.which("g++")
        if cxx is not None:
            try:
                if not os.path.isfile(out):
                    _compile([cxx, *HOST_CXX_FLAGS], src, out, "g++")
                lib = ctypes.CDLL(out)
                declare(lib)
            except (RuntimeError, OSError):
                lib = None
        _loaded[name] = lib
        return lib


def check_tensors(o, *named):
    """Raise unless every (name, tensor, dtype, shape) lies on o's device
    with that dtype and shape (shape None: any)."""
    for name, x, dtype, shape in named:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")


def launch(get_lib, entry, device, *args):
    """Call kernel entry point `entry` of the library `get_lib()` returns
    on the current stream of `device`; tensors pass as their data
    pointers.  Raises unless the device is a GPU, and on a launch error."""
    import torch

    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    fn = getattr(get_lib(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
