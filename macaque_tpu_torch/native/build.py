"""Build + ctypes loader for the native parity kernel library.

``pictorial.cpp`` is compiled with one ``g++ -O3 -fopenmp -shared -fPIC``
call into ``_build/`` beside the package (``MACAQUE_TPU_TORCH_BUILD``
overrides it, as for the CUDA kernels), under a name that carries a hash
of the source and the command: a library built from the same source is
reused. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "pictorial.cpp")
_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]


def _build_dir() -> str:
    return os.environ.get("MACAQUE_TPU_TORCH_BUILD",
                          os.path.join(os.path.dirname(_DIR), "_build"))


def library_path(build_dir: str | None = None) -> str:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir or _build_dir(),
                        f"libmacaque_native_{h.hexdigest()[:16]}.so")


def _build(lib: str) -> str:
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC}:\n{proc.stderr}")
    os.replace(tmp, lib)       # atomic: concurrent builds agree
    return lib


@lru_cache(maxsize=None)
def load_native(build_dir: str | None = None):
    """Load (building if needed) the native library; returns a wrapper
    object with ``pictorial_infer`` and ``transform_closure``."""
    path = library_path(build_dir)
    if not os.path.exists(path):
        _build(path)
    lib = ctypes.CDLL(path)
    lib.pictorial_infer.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.transform_closure.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.pictorial_infer.restype = None
    lib.transform_closure.restype = None

    class Native:
        library = path

        @staticmethod
        def pictorial_infer(unary, candidates, bone_mean, bone_std):
            unary = np.ascontiguousarray(unary, dtype=np.float64)
            candidates = np.ascontiguousarray(candidates, dtype=np.float64)
            bone_mean = np.ascontiguousarray(bone_mean, dtype=np.float64)
            bone_std = np.ascontiguousarray(bone_std, dtype=np.float64)
            n_cand = unary.shape[1] if unary.ndim == 2 else 0
            if (unary.shape != (13, n_cand) or n_cand < 1
                    or candidates.shape != (13, n_cand, 3)
                    or bone_mean.shape != (13,) or bone_std.shape != (13,)):
                raise ValueError(
                    "pictorial_infer takes unary (13, C), candidates "
                    f"(13, C, 3) and (13,) bone priors, got {unary.shape}, "
                    f"{candidates.shape}, {bone_mean.shape}, {bone_std.shape}")
            out = np.zeros(13, dtype=np.int64)
            lib.pictorial_infer(
                unary.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                candidates.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                bone_mean.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                bone_std.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                n_cand,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            return out

        @staticmethod
        def transform_closure(x):
            x = np.ascontiguousarray(x, dtype=np.uint8)
            if x.ndim != 2 or x.shape[0] != x.shape[1]:
                raise ValueError(f"transform_closure takes an (N, N) "
                                 f"relation, got {x.shape}")
            n = x.shape[0]
            out = np.zeros_like(x)
            lib.transform_closure(
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            return out

    return Native()


def native_available() -> bool:
    """True when ``load_native()`` builds (or finds) and loads the library,
    False on any failure."""
    try:
        load_native()
        return True
    except Exception:  # noqa: BLE001 (any failure means "not available")
        return False
