"""Native (C++/OpenMP) parity kernels, loaded via ctypes.

The port's own copy of the JAX package's native layer (which mirrors the
reference's Cython/C + OpenMP in src/m_lib/): CPU oracle implementations
of the pictorial-structure kernels, used by the tests and by
``chip_smoke.py`` to cross-check ``association/pictorial.py``. Host C++,
built with one ``g++`` call; no CUDA.
"""

from macaque_tpu_torch.native.build import (
    library_path, load_native, native_available)
