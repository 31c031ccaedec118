"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, at first use, into ``moc_tpu_torch/build/``. The library
name carries a hash of the source and the flags, so an edited source never
loads a stale build. Nothing here runs at import time: the CPU tests import
every module on hosts without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build")
# sm_90a (not sm_90) keeps Hopper-only instructions available to the kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    """Every kernel source under ``csrc/``, by name."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found (need the CUDA toolkit on PATH or "
                           "under /usr/local/cuda) to build the port's kernels")
    return path


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str) -> tuple[subprocess.Popen, str, str]:
    out = library_path(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile every named kernel (default: all) that has no current build,
    one ``nvcc`` per source, all started together. Returns, per name, the
    library path, the wall seconds and the compiler's log (``-Xptxas -v``
    prints registers, shared memory and spills). Raises on a failed build."""
    names = kernel_names() if names is None else names
    t0 = time.perf_counter()
    result, running = {}, {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            result[name] = {"path": path, "seconds": 0.0, "log": "cached"}
        else:
            running[name] = _start(name)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        result[name] = {"path": out, "seconds": time.perf_counter() - t0,
                        "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build([name])[name]["path"])
        return _loaded[name]
