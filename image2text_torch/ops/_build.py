"""Build and load the port's CUDA kernels.

Each ``image2text_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), under ``build/image2text_torch/`` at the repository
root, keyed by a hash of the sources and flags.  The libraries load with
``ctypes``; every pointer and the stream pass as ``c_void_p``.  Nothing
here runs at import time: the first kernel launch builds what it needs,
and :func:`build_all` builds every source at once, one ``nvcc`` per source
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "image2text_torch"
SOURCES = ("fused_moe", "fused_block", "flash_attention", "int4_matmul",
           "fused_frontend", "topk_mask")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> List[str]:
    """Compile every source not yet built, all ``nvcc`` processes started
    together; returns the compiler logs (``-Xptxas -v`` resource use)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs.append(f"== {name}.cu ==\n{log}")
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def check_operand(kernel: str, name: str, t, dtype) -> None:
    """Raise unless ``t`` (None allowed) is a contiguous, 16-byte aligned
    CUDA tensor of ``dtype`` — what the kernels' vector loads take."""
    if t is None:
        return
    if (t.dtype != dtype or not t.is_cuda or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"{kernel} kernel: {name} must be a contiguous, "
                         f"16-byte aligned {dtype} CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
