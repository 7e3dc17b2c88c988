"""Build and load the CUDA kernels of ``csrc/``.

On first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one process per source, all started together) and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``dgcnn_tpu_torch/build/`` under a name holding the
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing here runs when a module is imported:
the CPU tests import every module on hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# seconds the last build took (0.0 when the library was already built)
build_seconds: float | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of dgcnn_tpu_torch "
        "are built from csrc/ on first use")


def _sources() -> tuple[list[str], str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in deps:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return srcs, h.hexdigest()[:16]


def _compile(srcs: list[str], lib_path: str) -> None:
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in srcs:
        obj = os.path.join(
            BUILD_DIR, os.path.basename(src)[:-3] + f".{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            failed.append(os.path.basename(src))
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = lib_path + f".{tag}.tmp"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *objs, "-o", tmp], capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from csrc/ if it is missing."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            srcs, digest = _sources()
            path = os.path.join(BUILD_DIR, f"libdgcnn_kernels_{digest}.so")
            t0 = time.perf_counter()
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                _compile(srcs, path)
            build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(path)
            lib.dg_cuda_error_string.restype = ctypes.c_char_p
            lib.dg_cuda_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if rc != 0:
        msg = load_library().dg_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p | None:
    """The device address of tensor ``t`` (None: a null pointer)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
