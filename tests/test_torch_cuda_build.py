"""ops/cuda_build on the CPU: the library path of a kernel source names its
contents, the headers of csrc/ that it includes among them, so that an
edited header rebuilds every source that includes it and no other. No
nvcc is needed: only paths are computed."""

import os
import shutil

from portfoliooptgp_tpu_torch.ops import cuda_build


def _copy_csrc(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, dst)
    monkeypatch.setattr(cuda_build, "CSRC", str(dst))
    monkeypatch.setenv("PORTFOLIOOPTGP_BUILD_DIR", str(tmp_path / "build"))
    return dst


def test_torch_cuda_build_sources_list_their_headers():
    assert cuda_build._source_files("blocked_panel") == ["blocked_panel.cu", "chol_tile.cuh",
                                                         "hopper_async.cuh"]
    assert cuda_build._source_files("dense_nll") == ["dense_nll.cu", "chol_tile.cuh",
                                                     "hopper_async.cuh", "nll_tile.cuh"]
    assert cuda_build._source_files("trinv") == ["trinv.cu", "hopper_async.cuh"]
    assert cuda_build._source_files("stationary_nll") == ["stationary_nll.cu", "chol_tile.cuh",
                                                          "nll_tile.cuh"]
    for name in cuda_build.SOURCES:
        for f in cuda_build._source_files(name):
            assert os.path.exists(os.path.join(cuda_build.CSRC, f))


def test_torch_cuda_build_header_edit_changes_library_path(tmp_path, monkeypatch):
    """Editing a header's bytes in a copy of csrc/ moves the library path of
    the three sources that include it, and of no other source; editing a
    source moves its own path only."""
    dst = _copy_csrc(tmp_path, monkeypatch)
    before = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    with open(dst / "hopper_async.cuh", "ab") as fh:
        fh.write(b"// edited\n")
    after = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    changed = {name for name in cuda_build.SOURCES if before[name] != after[name]}
    assert changed == {"blocked_panel", "trinv", "dense_nll"}
    with open(dst / "dense_nll.cu", "ab") as fh:
        fh.write(b"// edited\n")
    again = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    assert {name for name in cuda_build.SOURCES if again[name] != after[name]} == {"dense_nll"}
    assert all(p.startswith(str(tmp_path / "build")) for p in again.values())


def test_torch_cuda_build_tile_header_edit_moves_its_two_sources(tmp_path, monkeypatch):
    """The warp-factor header chol_tile.cuh is shared by the panel factor and
    the two NLL kernels on the tile core (dense and stationary, through
    nll_tile.cuh): editing it moves their library paths and no other."""
    dst = _copy_csrc(tmp_path, monkeypatch)
    before = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    with open(dst / "chol_tile.cuh", "ab") as fh:
        fh.write(b"// edited\n")
    after = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    assert {name for name in cuda_build.SOURCES
            if before[name] != after[name]} == {"blocked_panel", "dense_nll", "stationary_nll"}


def test_torch_cuda_build_nll_tile_header_edit_moves_the_nll_sources(tmp_path, monkeypatch):
    """The tile core nll_tile.cuh is shared by the dense and the stationary
    NLL kernels: editing it moves their library paths and no other."""
    dst = _copy_csrc(tmp_path, monkeypatch)
    before = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    with open(dst / "nll_tile.cuh", "ab") as fh:
        fh.write(b"// edited\n")
    after = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    assert {name for name in cuda_build.SOURCES
            if before[name] != after[name]} == {"dense_nll", "stationary_nll"}
