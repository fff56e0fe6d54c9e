"""Build and load the port's CUDA kernels.

Each ``image2text_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), under ``build/image2text_torch/`` at the repository
root, keyed by a hash of the sources and flags.  The libraries load with
``ctypes``; every pointer and the stream pass as ``c_void_p``.  Nothing
here runs at import time: the first kernel launch builds what it needs,
and :func:`build_all` builds every source at once, one ``nvcc`` per source
started together.

A source may also be built with preprocessor defines (``-DNAME=VALUE``):
the measurement variants of ``csrc/fused_block.cu`` and ``csrc/fused_moe.cu``
(``image2text_torch/probes/``).  Each distinct set of defines is its own
library, ``lib<name>-<hash>.so`` with the defines in the hash key; the
shipping build passes none.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple, Union

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "image2text_torch"
SOURCES = ("fused_moe", "fused_block", "flash_attention", "int4_matmul",
           "fused_frontend", "topk_mask", "flash_attention_f32")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v", "-ldl"]

# A build unit: a source name, or (name, defines) with defines a tuple of
# "NAME=VALUE" strings.
Unit = Union[str, Tuple[str, Tuple[str, ...]]]

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _unit(u: Unit) -> Tuple[str, Tuple[str, ...]]:
    return (u, ()) if isinstance(u, str) else (u[0], tuple(sorted(u[1])))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _flags(defines: Tuple[str, ...]) -> List[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(units: Iterable[Unit] = SOURCES) -> List[str]:
    """Compile every unit (a source, or a source with defines) not yet
    built, all ``nvcc`` processes started together; returns the compiler
    logs (``-Xptxas -v`` resource use)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defines in dict.fromkeys(map(_unit, units)):
        out = _lib_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        label = f"{name}.cu" + (f" [{' '.join(defines)}]" if defines else "")
        procs.append((label, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    failed = []
    for label, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs.append(f"== {label} ==\n{log}")
        if proc.returncode != 0:
            failed.append(label)
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    return logs


def load(name: str, defines: Iterable[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``
    (none: the shipping build), built on first use."""
    key = _unit((name, tuple(defines)))
    lib = _loaded.get(key)
    if lib is None:
        path = _lib_path(*key)
        if not path.exists():
            build_all([key])
        lib = ctypes.CDLL(str(path))
        _loaded[key] = lib
    return lib


def kernel_constants(name: str, *names: str) -> Tuple[int, ...]:
    """``constexpr int NAME = <literal>;`` values of ``csrc/<name>.cu``:
    a kernel's tiling has one owner, its source, which the host's launch
    plans read."""
    text = (CSRC / f"{name}.cu").read_text()
    found = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    return tuple(int(found[n]) for n in names)


def resources(name: str, kernel: str) -> Tuple[int, int]:
    """(registers, spill store bytes) of the first kernel of
    ``csrc/<name>.cu``'s shipping build whose mangled name contains
    ``kernel`` (e.g. ``"flash_fwd_res_kernelILi128E"``), from the build's
    ``-Xptxas -v`` log; built first if needed."""
    load(name)
    log = _lib_path(name).with_suffix(".log").read_text()
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or kernel not in entry:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            return int(m.group(1)), spills
    raise KeyError(f"{kernel} not in the {name}.cu build log")


_entry_points: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def entry_point(source: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """``name`` of the shipping build of ``csrc/<source>.cu``, returning a
    ``cudaError_t`` and taking ``argtypes`` (so plain Python ints and
    floats pass without ctypes wrappers); loaded once."""
    fn = _entry_points.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _entry_points[(source, name)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, for a C entry
    point's ``void* stream`` (the raw query: a few µs cheaper a launch than
    building a ``torch.cuda.Stream``)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


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
