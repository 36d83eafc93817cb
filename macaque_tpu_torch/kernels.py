"""Build, load and count the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources go through one ``nvcc`` call into one shared
library with a plain C interface, loaded with ``ctypes``; the headers
beside them (``csrc/*.cuh``: ``ptx.cuh``, the PTX helpers of every
tensor-core kernel, and ``attention_core.cuh``, the attention template of
K1 and K4) are included by the sources. The build runs at
first use, into ``_build/`` beside this file (override with
``MACAQUE_TPU_TORCH_BUILD``), and is reused while the sources and headers
are unchanged: the library's name carries a hash of their contents.

Every C entry point launches on the current CUDA device and returns
``cudaGetLastError()`` after its launch. The wrappers call them through
:func:`launch`, which makes the input's device current around the call
(a shard of a mesh on ``cuda:1`` must not launch on ``cuda:0``), passes
that device's current stream, and turns a non-zero code into an
exception. ``LAUNCHES`` holds one plain integer per kernel, which
:func:`launch` raises by one each time a wrapper launches the kernel, and
nowhere else; the same count reaches the current record of
``core/trace.py`` as ``launches.<kernel>``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

from macaque_tpu_torch.core.trace import count

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.environ.get(
    "MACAQUE_TPU_TORCH_BUILD",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build"))
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

LAUNCHES = {"packed_attention": 0, "roi_align_windowed": 0, "quantize_rows": 0,
            "quant_int8_matmul": 0, "window_attention": 0, "attention": 0,
            "swin_block": 0, "relpos_attention": 0}

_lock = threading.Lock()
_lib = None
build_log = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> list[str]:
    """The files nvcc compiles: ``csrc/*.cu``, without the headers."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _hashed_files() -> list[str]:
    """What the library is built from: the sources and the headers."""
    return sorted(sources() + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    h = hashlib.sha256(ARCH.encode())
    for src in _hashed_files():
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
            lib.macaque_quant_int8_matmul.argtypes = [p] * 8 + [i] * 3 + [p]
            lib.macaque_quant_int8_matmul.restype = i
            lib.macaque_window_attention.argtypes = [
                p, p, p, p, i, i, i, i, i, f, i, i, p]
            lib.macaque_window_attention.restype = i
            lib.macaque_attention.argtypes = [p, p, p, p, i, i, i, i, f, p]
            lib.macaque_attention.restype = i
            lib.macaque_relpos_attention.argtypes = [p, p, p, p, i, i, i, i, i,
                                                     f, p]
            lib.macaque_relpos_attention.restype = i
            for fn in (lib.macaque_attention_blocks_per_sm,
                       lib.macaque_packed_attention_blocks_per_sm,
                       lib.macaque_quant_int8_matmul_blocks_per_sm,
                       lib.macaque_roi_align_windowed_blocks_per_sm):
                fn.argtypes = [ctypes.POINTER(i)]
                fn.restype = i
            lib.macaque_window_attention_blocks_per_sm.argtypes = [
                i, i, ctypes.POINTER(i)]
            lib.macaque_window_attention_blocks_per_sm.restype = i
            lib.macaque_relpos_attention_blocks_per_sm.argtypes = [
                i, ctypes.POINTER(i)]
            lib.macaque_relpos_attention_blocks_per_sm.restype = i
            lib.macaque_swin_block_slots.argtypes = [i, ctypes.POINTER(i)]
            lib.macaque_swin_block_slots.restype = i
            lib.macaque_swin_block_layout.argtypes = [
                i, ctypes.POINTER(i), ctypes.POINTER(i)]
            lib.macaque_swin_block_layout.restype = i
            lib.macaque_swin_block.argtypes = [p] * 18 + [i] * 5 + [f, p]
            lib.macaque_swin_block.restype = i
            _lib = lib
    return _lib


def resident_blocks(name: str, *variant: int) -> int:
    """Blocks of the kernel ``name`` ("attention", "packed_attention",
    "quant_int8_matmul" (K5b's GEMM), "roi_align_windowed",
    "window_attention" with the variant ``dtype, blocked``: dtype 0 = f32,
    1 = bf16, or "relpos_attention" with the variant ``grid``, 14 or 64)
    that one SM of the current device keeps resident."""
    n = ctypes.c_int(0)
    query = getattr(library(), f"macaque_{name}_blocks_per_sm")
    check(query(*variant, ctypes.byref(n)), f"{name} occupancy")
    return n.value


def ptxas_stats(kernel: str, log: str | None = None) -> dict | None:
    """Registers and spill bytes that ptxas reported (``-Xptxas -v``) for
    the ``__global__`` function named ``kernel`` in ``log`` (default: this
    process's build log), or None where the log does not name it."""
    tag = f"{len(kernel)}{kernel}"     # its length-prefixed mangled name
    stats, mine, props = None, False, False
    for line in (build_log if log is None else log).splitlines():
        if "Compiling entry function" in line:
            mine = tag in line
            if mine:
                stats = {}
        elif "Function properties for" in line:
            props = mine and tag in line
        elif mine:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              line)
            if spill and props:
                stats["spill_stores"], stats["spill_loads"] = map(int, spill.groups())
            used = re.search(r"Used (\d+) registers", line)
            if used:
                stats.setdefault("registers", int(used.group(1)))
    return stats


def refuse_grad(name: str, *tensors) -> None:
    """Raise before a launch that autograd would lose: a kernel's output is
    a fresh tensor with no ``grad_fn``, so every gradient upstream of it
    would silently be zero. Serving runs under ``no_grad`` or with frozen
    weights; training takes the plain, differentiable paths."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward and an input requires grad; "
            "run under torch.no_grad() or take the plain version")


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(kernel: str, entry: str, device, *args, name: str | None = None
           ) -> None:
    """Call the C entry point ``macaque_<entry>`` with ``args`` and the
    current stream of ``device`` as its last argument, with ``device``
    made the current CUDA device around the call; raise under ``name``
    (default ``kernel``) on a launch error, and count one launch of
    ``kernel``."""
    import torch

    with torch.cuda.device(device):
        err = getattr(library(), f"macaque_{entry}")(
            *args, current_stream(device))
    check(err, name or kernel)
    count(f"launches.{kernel}", total=(LAUNCHES, kernel))
