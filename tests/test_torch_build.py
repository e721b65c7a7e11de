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
    # the MRF forward and the tail keep the table and the mean of the shared
    # header and contract on the tensor-core core, which brings the weight
    # gradient's reduction header with it; every kernel opts into its shared
    # memory through one header
    mrf = ["bwd_common.cuh", "cp_async.cuh", "mma_common.cuh", "mrf_common.cuh", "smem_attr.cuh"]
    assert names["fused_tail"] == mrf
    assert names["fused_mrf"] == mrf
    # the chain's forward and the decode (its bf16 form's wgmma and copies)
    # run on the tensor-core core too, without the MRF's table
    core = ["bwd_common.cuh", "cp_async.cuh", "mma_common.cuh", "smem_attr.cuh"]
    assert names["basis_decode"] == core
    assert names["fused_resstack"] == core


def test_backward_kernels_share_one_header_and_its_hash():
    names = {src.stem: [p.name for p in _build.local_includes(src)]
             for src in _build.CSRC.glob("*.cu")}
    core = ["bwd_common.cuh", "cp_async.cuh", "mma_common.cuh", "smem_attr.cuh"]
    assert names["fused_resstack_bwd"] == core
    assert names["fused_mrf_bwd"] == core
    # the discriminators' grouped conv takes the copies alone, not the core
    assert names["grouped_conv"] == ["cp_async.cuh", "smem_attr.cuh"]
    assert sorted(names) == ["basis_decode", "fused_mrf", "fused_mrf_bwd", "fused_resstack",
                             "fused_resstack_bwd", "fused_tail", "grouped_conv"]


def _copied_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    return csrc


def test_a_backward_library_is_rebuilt_when_the_shared_header_changes(tmp_path, monkeypatch):
    csrc = _copied_csrc(tmp_path)
    names = ("fused_mrf_bwd", "fused_resstack_bwd", "fused_mrf", "fused_tail", "basis_decode")
    before = {n: _build._target(csrc / f"{n}.cu") for n in names}
    with open(csrc / "bwd_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._target(csrc / f"{n}.cu") for n in before}
    assert after["fused_mrf_bwd"] != before["fused_mrf_bwd"]
    assert after["fused_resstack_bwd"] != before["fused_resstack_bwd"]
    # through mma_common.cuh
    assert after["fused_mrf"] != before["fused_mrf"]
    assert after["fused_tail"] != before["fused_tail"]
    assert after["basis_decode"] != before["basis_decode"]


def test_both_mrf_libraries_are_rebuilt_when_the_tensor_core_header_changes(tmp_path):
    csrc = _copied_csrc(tmp_path)
    names = ("fused_mrf", "fused_mrf_bwd", "fused_tail", "fused_resstack", "fused_resstack_bwd",
             "basis_decode", "grouped_conv")
    before = {n: _build._target(csrc / f"{n}.cu") for n in names}
    with open(csrc / "mma_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._target(csrc / f"{n}.cu") for n in names}
    assert after["fused_mrf"] != before["fused_mrf"]
    assert after["fused_mrf_bwd"] != before["fused_mrf_bwd"]
    # and the tail, both chain libraries and the decode, which contract on the same core
    assert after["fused_tail"] != before["fused_tail"]
    assert after["fused_resstack"] != before["fused_resstack"]
    assert after["fused_resstack_bwd"] != before["fused_resstack_bwd"]
    assert after["basis_decode"] != before["basis_decode"]
    # the discriminators' grouped conv runs on the CUDA cores, without the core
    assert after["grouped_conv"] == before["grouped_conv"]


def test_the_tail_library_alone_is_rebuilt_when_the_mrf_header_changes(tmp_path):
    csrc = _copied_csrc(tmp_path)
    names = ("fused_tail", "fused_mrf", "fused_resstack", "fused_resstack_bwd", "fused_mrf_bwd",
             "basis_decode")
    before = {n: _build._target(csrc / f"{n}.cu") for n in names}
    with open(csrc / "mrf_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._target(csrc / f"{n}.cu") for n in names}
    assert after["fused_tail"] != before["fused_tail"]
    assert after["fused_mrf"] != before["fused_mrf"]
    for n in ("fused_resstack", "fused_resstack_bwd", "fused_mrf_bwd", "basis_decode"):
        assert after[n] == before[n]


def test_every_library_is_rebuilt_when_the_shared_memory_header_changes(tmp_path):
    csrc = _copied_csrc(tmp_path)
    sources = sorted(csrc.glob("*.cu"))
    before = {src.stem: _build._target(src) for src in sources}
    with open(csrc / "smem_attr.cuh", "a") as f:
        f.write("// edited\n")
    assert all(_build._target(src) != before[src.stem] for src in sources)
    assert len(sources) == 7


def test_refuse_autograd_speaks_of_an_inference_only_kernel():
    import pytest
    import torch

    x = torch.zeros(1, requires_grad=True)
    with pytest.raises(NotImplementedError, match="inference only"):
        _build.refuse_autograd("fused_tail", [x])
    with torch.no_grad():
        _build.refuse_autograd("fused_tail", [x])
