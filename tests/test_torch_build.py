"""The kernel build (`fastvocoder_tpu_torch/ops/_build.py`) on the CPU: a
library is keyed on its source and every local header it includes, so
editing a shared header rebuilds each library that includes it.  Nothing
here compiles: the CPU has no nvcc."""

from fastvocoder_tpu_torch.ops import _build


def _write(path, text):
    path.write_text(text)
    return path


def test_local_includes_follow_nested_headers(tmp_path):
    (tmp_path / "sub").mkdir()
    _write(tmp_path / "sub" / "leaf.cuh", "#pragma once\n")
    _write(tmp_path / "common.cuh",
           '#pragma once\n#include "sub/leaf.cuh"\n#include <cuda_runtime.h>\n')
    src = _write(tmp_path / "k.cu", '  #include "common.cuh"\n#include "missing.cuh"\nint f();\n')
    assert [p.name for p in _build.local_includes(src)] == ["common.cuh", "leaf.cuh"]


def test_target_changes_with_an_included_header(tmp_path):
    header = _write(tmp_path / "common.cuh", "#pragma once\nconstexpr int kA = 1;\n")
    src = _write(tmp_path / "k.cu", '#include "common.cuh"\nint f() { return kA; }\n')
    other = _write(tmp_path / "o.cu", "int g() { return 2; }\n")
    before, other_before = _build._target(src), _build._target(other)
    assert before == _build._target(src)  # stable while nothing changes
    header.write_text("#pragma once\nconstexpr int kA = 2;\n")
    assert _build._target(src) != before
    assert _build._target(other) == other_before


def test_port_kernels_that_share_the_mrf_header():
    names = {src.stem: [p.name for p in _build.local_includes(src)]
             for src in _build.CSRC.glob("*.cu")}
    assert names["fused_mrf"] == names["fused_tail"] == ["mrf_common.cuh"]
    assert names["basis_decode"] == names["fused_resstack"] == []
