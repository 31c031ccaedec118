"""ctypes binding of the native bag packer (``moc_tpu_torch/native/bagpack.cpp``,
a byte-for-byte copy of the JAX package's ``native/bagpack.cpp``; PyTorch
port of ``moc_tpu/data/native.py``).

The source compiles with ``g++`` at first use into ``moc_tpu_torch/build/``
with the JAX package's flags (``-O3 -march=native``: the quantizer's
``nearbyintf`` is one instruction only with SSE4.1, a libm call without it)
under a name that carries a hash of the source, the flags, the compiler's
version, the host and its CPU model, so a build made on another machine is
never loaded.
Several processes may start at once (the tests run six workers): the build
holds a file lock, compiles to a temporary name and moves it into place.

Callers that must not run without the library pass ``required=True`` (the
packer does so for every batch bound for the GPU): a failed build then
raises with g++'s messages. Otherwise a failed build falls back to numpy,
which gives the same bytes. ``native_calls`` counts the calls that ran the
library, per entry point.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from typing import Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PATH = os.path.join(_PKG, "native", "bagpack.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None  # why the last build failed
native_calls = {"pack": 0, "quantize": 0, "gather": 0}


def _gxx_version() -> str:
    try:
        return subprocess.run(["g++", "--version"], capture_output=True, text=True,
                              timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return ""


def library_path() -> str:
    """The build of ``bagpack.cpp`` for this host: the name hashes the
    source, the flags, ``g++ --version``, ``platform.uname()`` and the CPU
    model (``-march=native`` code runs only where it was built)."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC_PATH, "rb") as f:
        digest.update(f.read())
    digest.update(_gxx_version().encode())
    digest.update(repr(tuple(platform.uname())).encode())
    digest.update(_cpu_model().encode())
    return os.path.join(BUILD_DIR, f"libbagpack-{digest.hexdigest()[:12]}.so")


def build_native() -> str:
    """Compile ``bagpack.cpp`` unless this host's build exists; returns its
    path. Raises RuntimeError with g++'s output when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libbagpack.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one compiler at a time, across processes
        try:
            if os.path.exists(out):  # another process built it while we waited
                return out
            tmp = f"{out}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SRC_PATH],
                                      capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"g++ could not run to build {SRC_PATH}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SRC_PATH}:\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fp = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    for name, src_t in (("pack_bags_f32", fp), ("pack_bags_f16", ctypes.POINTER(ctypes.c_uint16))):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(src_t), i64p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, fp, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.gather_pack_f32.restype = None
    lib.gather_pack_f32.argtypes = [ctypes.POINTER(fp), i64p, i64p, i64p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64, fp, ctypes.c_int]
    lib.quantize_rows_i8.restype = None
    lib.quantize_rows_i8.argtypes = [fp, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int8), fp, ctypes.c_int]
    return lib


def _load(required: bool = False) -> ctypes.CDLL | None:
    """The bound library, built on first use; None when the build failed,
    or a RuntimeError with the compiler's output under ``required``."""
    global _lib, _error
    with _lock:
        if _lib is None and (_error is None or required):
            try:
                _lib = _bind(ctypes.CDLL(build_native()))
                _error = None
            except (OSError, RuntimeError) as e:
                _error = str(e)
        if _lib is None and required:
            raise RuntimeError(f"the native bag packer is required here: {_error}")
        return _lib


def native_available() -> bool:
    return _load() is not None


def pack_bags_native(features: Sequence[np.ndarray], n_pad: int, n_threads: int = 8, *,
                     out: np.ndarray | None = None, required: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Pad and stack ``[n_i, D]`` feature arrays into ``(features [B, n_pad,
    D] f32, mask [B, n_pad] bool)``, into ``out`` when given (a C-contiguous
    f32 buffer of that shape, e.g. a pinned tensor's numpy view). f32 and f16
    sources go through the library; other dtypes, or no library, through
    numpy."""
    b = len(features)
    d = features[0].shape[1] if b else 0
    if any(f.ndim != 2 or f.shape[1] != d for f in features):
        raise ValueError(f"bags must be [n, {d}] arrays of one feature dim, got "
                         f"{sorted({f.shape for f in features})}")
    if out is None:
        out = np.empty((b, n_pad, d), np.float32)
    elif out.shape != (b, n_pad, d) or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 [{b}, {n_pad}, {d}] buffer, got "
                         f"{out.dtype} {out.shape}")
    if b == 0:
        return out, np.zeros((0, n_pad), bool)
    dtype = features[0].dtype
    lib = _load(required) if all(f.dtype == dtype for f in features) else None
    if lib is None or dtype not in (np.float32, np.float16):
        mask = np.zeros((b, n_pad), bool)
        for i, f in enumerate(features):
            n = min(len(f), n_pad)
            out[i, :n] = f[:n]
            out[i, n:] = 0.0
            mask[i, :n] = True
        return out, mask
    arrays = [np.ascontiguousarray(f) for f in features]
    lengths = np.asarray([len(f) for f in arrays], np.int64)
    mask = np.empty((b, n_pad), np.uint8)
    elem_t, fn = ((ctypes.c_float, lib.pack_bags_f32) if dtype == np.float32
                  else (ctypes.c_uint16, lib.pack_bags_f16))
    ptr_t = ctypes.POINTER(elem_t)
    ptrs = (ptr_t * b)(*[a.ctypes.data_as(ptr_t) for a in arrays])
    fn(ptrs, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), b, d, n_pad,
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
       mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    native_calls["pack"] += 1
    return out, mask.view(bool)


def quantize_rows_i8(x: np.ndarray, n_threads: int = 8, *,
                     out: tuple[np.ndarray, np.ndarray] | None = None,
                     required: bool = False) -> tuple[np.ndarray, np.ndarray] | None:
    """Per-row symmetric int8 quantization of contiguous f32 ``[..., N, D]``
    features → ``(q int8, scales f32 [..., N])`` in one pass, into ``out``
    when given; None when the library is missing or ``x`` is not contiguous
    f32 (the caller then uses numpy, bit for bit the same)."""
    if x.dtype != np.float32 or not x.flags.c_contiguous or x.ndim < 2:
        return None
    lib = _load(required)
    if lib is None:
        return None
    q, scales = out if out is not None else (np.empty(x.shape, np.int8),
                                             np.empty(x.shape[:-1], np.float32))
    for buf, shape, dtype in ((q, x.shape, np.int8), (scales, x.shape[:-1], np.float32)):
        if buf.shape != shape or buf.dtype != dtype or not buf.flags.c_contiguous:
            raise ValueError(f"out buffers must be C-contiguous int8 {x.shape} and float32 "
                             f"{x.shape[:-1]}, got {buf.dtype} {buf.shape}")
    fp = ctypes.POINTER(ctypes.c_float)
    lib.quantize_rows_i8(x.ctypes.data_as(fp), int(np.prod(x.shape[:-1], dtype=np.int64)),
                         x.shape[-1], q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                         scales.ctypes.data_as(fp), n_threads)
    native_calls["quantize"] += 1
    return q, scales


def gather_pack_f32(srcs: Sequence[np.ndarray], ncols: Sequence[int],
                    dst_row_off: Sequence[int], dst: np.ndarray, n_threads: int = 8, *,
                    required: bool = False) -> bool:
    """Copy each contiguous f32 chunk ``srcs[i] [rows_i, ncols_i, D]`` into
    ``dst[dst_row_off[i]:]`` (``dst [total_rows, n_pad, D]``), zero-filling
    each row's columns past ``ncols_i``, all chunks on threads. Returns False
    (the caller copies with numpy) without the library or when a chunk or
    ``dst`` is not contiguous f32."""
    if not srcs or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        return False
    if any(a.dtype != np.float32 or not a.flags.c_contiguous for a in srcs):
        return False
    for a, cn, off in zip(srcs, ncols, dst_row_off):
        if (a.ndim != 3 or a.shape[1] != cn or cn > dst.shape[1] or a.shape[2] != dst.shape[2]
                or not 0 <= off <= dst.shape[0] - a.shape[0]):
            raise ValueError(f"chunk {a.shape} with {cn} columns at row {off} does not fit "
                             f"dst {dst.shape}")
    lib = _load(required)
    if lib is None:
        return False
    rows = np.asarray([a.shape[0] for a in srcs], np.int64)
    cols = np.asarray(ncols, np.int64)
    offs = np.asarray(dst_row_off, np.int64)
    ptr_t = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.POINTER(ctypes.c_int64)
    ptrs = (ptr_t * len(srcs))(*[a.ctypes.data_as(ptr_t) for a in srcs])
    lib.gather_pack_f32(ptrs, rows.ctypes.data_as(i64), cols.ctypes.data_as(i64),
                        offs.ctypes.data_as(i64), len(srcs), dst.shape[1], dst.shape[2],
                        dst.ctypes.data_as(ptr_t), n_threads)
    native_calls["gather"] += 1
    return True
