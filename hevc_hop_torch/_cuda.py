"""Build and bind the hand-written CUDA kernels under csrc/.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/lib<name>.so`` (a plain C interface, no PyTorch headers) at first
use, and again whenever the source or a shared header is newer than the
library. The library is loaded with ``ctypes``: every pointer and the CUDA
stream travel as ``c_void_p``, integers as ``c_int``, floats as
``c_float``. Each C entry point returns ``cudaGetLastError()`` right after
its launch; :func:`check` raises on a non-zero code.

Nothing here runs at import time: this module is imported on machines that
have neither a card nor ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
# ptxas reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# compiler output of each library built by this process
BUILD_LOGS: dict = {}

_libs: dict = {}
_lock = threading.Lock()

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "hevc_hop_torch/csrc on a machine with the CUDA "
                       "toolkit")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not os.path.exists(out):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + glob.glob(
        os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(out) < max(os.path.getmtime(d) for d in deps)


def _start_build(name: str, flags=(), out: str | None = None) -> tuple:
    os.makedirs(BUILD, exist_ok=True)
    tmp = (out or _lib_path(name)) + f".tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, proc, tmp: str, out: str | None = None) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    BUILD_LOGS[name] = log
    os.replace(tmp, out or _lib_path(name))


def sources() -> list:
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _build(names) -> None:
    """Build the stale libraries among ``names``: one nvcc per source, all
    started together. The caller holds the lock."""
    jobs = [(n, *_start_build(n)) for n in names if _stale(n)]
    for name, proc, tmp in jobs:
        _finish_build(name, proc, tmp)


def build_all() -> None:
    """Build every stale kernel library at once."""
    with _lock:
        _build(sources())


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built if stale."""
    with _lock:
        if name in _libs:
            return _libs[name]
        _build([name])
        so = ctypes.CDLL(_lib_path(name))
        so.hh_error_string.restype = ctypes.c_char_p
        so.hh_error_string.argtypes = [ctypes.c_int]
        _libs[name] = so
        return so


def variant(name: str, tag: str, flags=()) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with the extra nvcc ``flags`` into
    build/lib<name>_<tag>.so and loaded, beside the library the wrappers
    use: the stage-clock build (``-DHH_STAGE_CLOCK``). Built once a
    process, beside :func:`build_all` if called from another thread."""
    out = os.path.join(BUILD, f"lib{name}_{tag}.so")
    with _lock:
        if out in _libs:
            return _libs[out]
    # its own output file: it may build beside build_all
    proc, tmp = _start_build(name, flags, out)
    _finish_build(f"{name}_{tag}", proc, tmp, out)
    so = ctypes.CDLL(out)
    so.hh_error_string.restype = ctypes.c_char_p
    so.hh_error_string.argtypes = [ctypes.c_int]
    with _lock:
        _libs[out] = so
    return so


def bind(name: str, fn: str, sig: str):
    """C entry point ``fn`` of ``csrc/<name>.cu``; ``sig`` spells its
    arguments, one letter each: p pointer/stream, i int, f float."""
    so = lib(name)
    f = getattr(so, fn)
    if f.argtypes is None:
        f.argtypes = [_CTYPES[c] for c in sig]
        f.restype = ctypes.c_int
    return f


def check(name: str, err: int) -> None:
    if err != 0:
        msg = lib(name).hh_error_string(err).decode()
        raise RuntimeError(f"CUDA launch in csrc/{name}.cu failed: {msg}")


def stream(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream

