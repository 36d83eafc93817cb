"""Build, load and count the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources go through one ``nvcc`` call into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, into ``_build/`` beside this file (override with
``MACAQUE_TPU_TORCH_BUILD``), and is reused while the sources are
unchanged: the library's name carries a hash of their contents.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception. ``LAUNCHES`` holds
one plain integer per kernel, which its wrapper raises by one each time
it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.environ.get(
    "MACAQUE_TPU_TORCH_BUILD",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build"))
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

LAUNCHES = {"packed_attention": 0, "roi_align_windowed": 0, "quantize_rows": 0,
            "quant_int8_matmul": 0, "window_attention": 0}

_lock = threading.Lock()
_lib = None
build_log = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    h = hashlib.sha256(ARCH.encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmacaque_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile every ``csrc/*.cu`` into one shared library (one nvcc call)
    unless a library built from the same sources exists. Returns its
    path; ``build_log`` keeps nvcc's output (registers, spills)."""
    global build_log
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", tmp, *sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, path)   # atomic: a concurrent process sees all or none
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.macaque_packed_attention.argtypes = [p, p, i, i, i, i, f, p]
            lib.macaque_packed_attention.restype = i
            lib.macaque_roi_align_windowed.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, p]
            lib.macaque_roi_align_windowed.restype = i
            lib.macaque_quantize_rows.argtypes = [p, p, p, i, i, p]
            lib.macaque_quantize_rows.restype = i
            lib.macaque_quant_int8_matmul.argtypes = [p, p, p, p, p, i, i, i, p]
            lib.macaque_quant_int8_matmul.restype = i
            lib.macaque_window_attention.argtypes = [
                p, p, p, p, i, i, i, i, i, f, i, i, p]
            lib.macaque_window_attention.restype = i
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
