"""The kernel build cache (``ops/cuda_build``) on the CPU: a library is keyed
by its source, the headers the source includes and its flags, so an edited
header gives another library and never loads a stale one. Nothing is
compiled here."""

from gaussctrl_exp_tpu_torch.ops import cuda_build


def test_the_attention_sources_follow_their_header():
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        assert [p.name for p in cuda_build.included(cuda_build.SOURCES[name])] == [f"{name}.cu", "tf32_mma.cuh"]
    assert [p.name for p in cuda_build.included(cuda_build.SOURCES["blend_fwd"])] == ["blend_fwd.cu"]


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
