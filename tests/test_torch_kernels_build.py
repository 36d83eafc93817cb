"""The kernel library's build bookkeeping, without nvcc: the library's
name covers every file it is built from (the ``.cu`` sources and the
``.cuh`` headers they include), nvcc is handed only the sources, and the
registers and spills of each kernel are read back from ptxas's log."""

import pytest

from macaque_tpu_torch import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "core.cuh"\n')
    (tmp_path / "b.cu").write_text("// b\n")
    (tmp_path / "core.cuh").write_text("// template, first version\n")
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    return tmp_path


def test_sources_are_the_cu_files_only(csrc):
    assert [p.rsplit("/", 1)[-1] for p in kernels.sources()] == ["a.cu", "b.cu"]


@pytest.mark.parametrize("edited", ["core.cuh", "a.cu"])
def test_library_path_follows_every_source_and_header(csrc, edited):
    before = kernels.library_path()
    assert kernels.library_path() == before          # stable while unchanged
    (csrc / edited).write_text("// edited\n")
    assert kernels.library_path() != before


def test_a_new_header_changes_the_library_path(csrc):
    before = kernels.library_path()
    (csrc / "extra.cuh").write_text("// new\n")
    assert kernels.library_path() != before


def test_the_repository_headers_are_hashed_but_not_compiled():
    names = [p.rsplit("/", 1)[-1] for p in kernels._hashed_files()]
    assert "attention_core.cuh" in names
    assert not [p for p in kernels.sources() if p.endswith(".cuh")]


# the shape of `nvcc -Xptxas -v` output for two translation units, with a
# subroutine's properties inside the first kernel's section
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116attention_kernelENS_8AttnArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116attention_kernelENS_8AttnArgsE
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Function properties for __internal_fdiv
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123packed_attention_kernelENS_8AttnArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123packed_attention_kernelENS_8AttnArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 152 registers, used 1 barriers, 400 bytes cmem[0]
"""


@pytest.mark.parametrize("kernel, want", [
    ("attention_kernel", {"registers": 168, "spill_stores": 8, "spill_loads": 12}),
    ("packed_attention_kernel", {"registers": 152, "spill_stores": 0,
                                 "spill_loads": 0}),
    ("swin_block_kernel", None)])
def test_ptxas_stats_reads_each_kernel_of_the_log(kernel, want):
    assert kernels.ptxas_stats(kernel, PTXAS_LOG) == want
