"""ctypes bindings of the port's C++ preprocessing core
(``image2text_torch/csrc/preproc.cc``, a copy of the repository's
``native/preproc.cc``).

The library is compiled at first use with ``g++ -O3 -march=native
-fopenmp -shared -fPIC`` (the JAX package's flags, so both builds give the
same bits) into ``build/image2text_torch/libpreproc-<hash>.so``; the hash
covers the source, the flags and the host CPU (``-march=native`` code
built on one machine may not run on another that reads the same tree).
Each build compiles to a temporary file of its own (``tempfile``: unique
across processes and threads) and renames it into place, so concurrent
first uses (xdist workers; a trainer's train and val prefetch threads)
never clash; in one process a lock makes one thread build and the others
wait for it.  There is no
silent fallback: where ``g++`` is missing or the build fails,
:func:`get_lib` raises with the compiler's message.  The numpy resize
(``training/data.py::_resize_bilinear``) is the plain version: the tests
hold the library to it, and non-uint8 input takes it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "preproc.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "image2text_torch"
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _host_cpu() -> bytes:
    """The CPU's model name and feature flags (what ``-march=native``
    compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
        keep = [ln for ln in lines
                if ln.startswith((b"model name", b"flags"))][:2]
        return b"\n".join(keep)
    except OSError:
        return platform.processor().encode()


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(platform.machine().encode() + _host_cpu())
    return BUILD_DIR / f"libpreproc-{h.hexdigest()[:16]}.so"


def build(out: Optional[Path] = None, compiler: str = "g++") -> Path:
    """Compile the source into ``out`` (default :func:`lib_path`) unless it
    is there; raises RuntimeError with the compiler's output on failure."""
    out = lib_path() if out is None else out
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, name = tempfile.mkstemp(suffix=".tmp", prefix=out.stem + ".",
                                dir=out.parent)
    os.close(fd)
    tmp = Path(name)
    cmd = [compiler, *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"the preprocessing core needs {compiler!r} "
                               f"to build {SOURCE.name}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed "
                               f"({' '.join(cmd)}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call (one thread builds,
    concurrent callers wait for it)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.resize_normalize_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            lib.resize_normalize_batch.restype = None
            lib.permute_gather.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.permute_gather.restype = None
            _LIB = lib
    return _LIB


def resize_normalize_batch(images: np.ndarray, size: int, mean: np.ndarray,
                           std: np.ndarray) -> np.ndarray:
    """(b, h, w, c) uint8 → (b, c, size, size) float32: bilinear
    half-pixel resize, /255, per-channel normalisation."""
    if images.ndim != 4 or images.dtype != np.uint8:
        raise ValueError(f"expected (b, h, w, c) uint8 images, got "
                         f"{images.dtype} {images.shape}")
    b, h, w, c = images.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    images = np.ascontiguousarray(images)
    out = np.empty((b, c, size, size), np.float32)
    get_lib().resize_normalize_batch(
        images.ctypes.data, b, h, w, c, out.ctypes.data, size,
        mean.ctypes.data, std.ctypes.data)
    return out
