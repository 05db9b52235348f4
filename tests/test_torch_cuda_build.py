"""The kernel build cache (``ops/cuda_build``) on the CPU: a library is keyed
by its source, the headers the source includes and its flags, so an edited
header gives another library and never loads a stale one; ``build`` starts
one nvcc per source asked for; and ``chip_smoke.sass_loops``, which reads
cuobjdump's listing of a built kernel. Nothing is compiled here."""

import pytest

import chip_smoke
from gaussctrl_exp_tpu_torch.ops import cuda_build


def test_the_attention_sources_follow_their_header():
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        assert [p.name for p in cuda_build.included(cuda_build.SOURCES[name])] == [f"{name}.cu", "tf32_mma.cuh"]
    # B1 and B2 share the staged gaussian and the exact sigma, alpha and T
    for name in ("blend_fwd", "blend_bwd"):
        assert [p.name for p in cuda_build.included(cuda_build.SOURCES[name])] == [f"{name}.cu", "blend_common.cuh"]
    assert [p.name for p in cuda_build.included(cuda_build.SOURCES["blend_variants"])] == ["blend_variants.cu"]


def test_only_the_blend_variants_forbid_fused_multiply_adds():
    """B1 and B2 keep the plain version's roundings with intrinsics that never
    fuse, so their files may fuse the rest; B1v forbids fusing in the whole
    file. B1 to B5 print their registers and spills."""
    for name in cuda_build.SOURCES:
        assert ("-fmad=false" in cuda_build.flags(name)) == (name == "blend_variants")
        assert (cuda_build.PTXAS_VERBOSE in cuda_build.flags(name)) == (name != "blend_variants")


@pytest.mark.parametrize("names", [("blend_fwd",), ("blend_fwd", "blend_bwd"), None])
def test_build_starts_one_nvcc_per_source_asked_for(tmp_path, monkeypatch, names):
    started = []

    class FakeNvcc:
        def __init__(self, cmd, stdout, stderr):
            started.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()

        def wait(self):
            return 0

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeNvcc)
    libs = cuda_build.build(names)
    want = list(cuda_build.SOURCES) if names is None else list(names)
    assert list(libs) == want and all(libs[n].exists() for n in want)
    assert [cmd[-1] for cmd in started] == [str(cuda_build.SOURCES[n]) for n in want]
    assert all(cmd[1:-3] == cuda_build.flags(n) for cmd, n in zip(started, want))
    cuda_build.build(names)  # every library is there: nothing is started again
    assert len(started) == len(want)


def test_a_changed_header_changes_the_library(tmp_path, monkeypatch):
    (tmp_path / "inc").mkdir()
    src, top, inner = tmp_path / "k.cu", tmp_path / "inc" / "a.cuh", tmp_path / "inc" / "b.cuh"
    src.write_text('#include <cuda_runtime.h>\n  #include "inc/a.cuh"\n#include "inc/a.cuh"\n')
    top.write_text('#pragma once\n#include "b.cuh"\n')
    inner.write_text("constexpr int N = 1;\n")
    monkeypatch.setitem(cuda_build.SOURCES, "k", src)
    assert cuda_build.included(src) == [src, top, inner]
    first = cuda_build.library_path("k")
    assert cuda_build.library_path("k") == first
    inner.write_text("constexpr int N = 2;\n")  # a header two includes down
    second = cuda_build.library_path("k")
    assert second != first and second.parent == first.parent and second.name.startswith("k_")
    top.write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert cuda_build.library_path("k") not in (first, second)
    monkeypatch.setitem(cuda_build.EXTRA_FLAGS, "k", ["-lineinfo"])  # and the flags
    assert cuda_build.library_path("k") not in (first, second)


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_116blend_bwd_kernelILi3EEEvPKfS2_
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                       /* 0x0000000000007919 */
        /*0020*/                   LDS.128 R4, [R2] ;                       /* 0x0000000000007919 */
        /*0030*/                   FFMA R4, R4, R5, R6 ;
        /*0040*/                   MUFU.EX2 R4, R4 ;
        /*0050*/                   SHFL.BFLY PT, R3, R4, 0x10, 0x1f ;
        /*0060*/                   LDS R8, [R10] ;
        /*0070*/                   ATOMS.CAST.SPIN R9, [R10], R8, R9 ;
        /*0080*/              @!P0 BRA 0x60 ;
        /*0090*/               @P1 BRA 0x20 ;
        /*00a0*/                   BRA 0xb0 ;
        /*00b0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_116blend_bwd_kernelILi4EEEvPKfS2_
        /*0000*/              @!P0 BRA 0x0 ;
"""


def test_sass_loops_reads_the_backward_branches_of_one_function():
    loops = chip_smoke.sass_loops(SASS, "blend_bwd_kernelILi3E")
    assert [(lp["start"], lp["end"], lp["instructions"]) for lp in loops] == [(0x60, 0x80, 3), (0x20, 0x90, 8)]
    inner, outer = loops
    assert (inner["LDS"], inner["ATOMS"], inner["BRA"], inner["SHFL"]) == (1, 1, 1, 0)
    assert (outer["FFMA"], outer["MUFU"], outer["LDS"], outer["SHFL"], outer["ATOMS"], outer["BRA"]) == (1, 1, 2, 1, 1, 2)
    assert chip_smoke.sass_loops(SASS, "blend_bwd_kernelILi4E") == [dict(
        start=0, end=0, instructions=1, **{c: int(c == "BRA") for c in chip_smoke.SASS_CLASSES})]
    assert chip_smoke.sass_loops(SASS, "blend_fwd_kernel") == []
