"""The kernel library's build bookkeeping, without nvcc: the library's
name covers every file it is built from (the ``.cu`` sources and the
``.cuh`` headers they include), nvcc is handed only the sources, and the
registers and spills of each kernel are read back from ptxas's log."""

import pytest

from macaque_tpu_torch import kernels
from macaque_tpu_torch.nn.swin_block import block_layout

SMEM_PER_BLOCK = 232_448       # shared memory an H100 gives one block
SMEM_PER_SM = 233_472          # 228 KB an SM, 1 KB of it reserved per block


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


# ptx.cuh holds the PTX helpers of K1-K4, K5b and K6; attention_core.cuh
# the attention template of K1 and K4
@pytest.mark.parametrize("header", ["ptx.cuh", "attention_core.cuh"])
def test_each_repository_header_is_hashed_and_not_compiled(header):
    assert header in [p.rsplit("/", 1)[-1] for p in kernels._hashed_files()]
    assert header not in [p.rsplit("/", 1)[-1] for p in kernels.sources()]


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


# the K5b GEMM and the fused Swin block, as their translation units list
# them (anonymous namespace, length-prefixed names)
PTXAS_LOG_TENSOR_CORES = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116int8_gemm_kernelEPKaPKfS1_S3_S3_P13__nv_bfloat16iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116int8_gemm_kernelEPKaPKfS1_S3_S3_P13__nv_bfloat16iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117swin_block_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117swin_block_kernelENS_6ParamsE
    24 bytes stack frame, 20 bytes spill stores, 24 bytes spill loads
ptxas info    : Function properties for __internal_accurate_fdividef
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 496 bytes cmem[0]
"""


@pytest.mark.parametrize("kernel, want", [
    ("int8_gemm_kernel", {"registers": 122, "spill_stores": 0, "spill_loads": 0}),
    ("swin_block_kernel", {"registers": 128, "spill_stores": 20,
                           "spill_loads": 24}),
    ("attention_kernel", None)])
def test_ptxas_stats_reads_the_gemm_kernels(kernel, want):
    assert kernels.ptxas_stats(kernel, PTXAS_LOG_TENSOR_CORES) == want


# the four Swin-S widths: one 64-row window a block, a (64, 5C) slot, and
# shared memory within a block's 232,448 bytes; two blocks an SM where the
# design counts on them (C <= 384, three quarters of the trunk's FLOP)
@pytest.mark.parametrize("C, per_sm", [(96, 2), (192, 2), (384, 2), (768, 1)])
def test_swin_block_layout_fits_the_card(C, per_sm):
    lay = block_layout(C)
    assert lay["rows"] == 64 and lay["slot"] == (64, 5 * C)
    assert lay["smem_bytes"] == 64 * (C + 8) * 2 + 61_440
    assert lay["smem_bytes"] <= SMEM_PER_BLOCK
    assert per_sm * (lay["smem_bytes"] + 1024) <= SMEM_PER_SM
