"""The kernel build of the PyTorch/CUDA port (ops/_build.py) on the CPU:
a library is named by its source, every shared header under csrc/ and
the nvcc flags, so an edit to any of them builds a new library and a
stale one is never loaded.  Nothing is compiled here (no nvcc)."""

import os

import pytest

from torchacc_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "shared.cuh").write_text("// helpers\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    return tmp_path


def test_sources_and_headers_found(csrc):
    assert _build.kernel_sources() == ["a", "b"]
    assert _build._headers() == ["shared.cuh"]


@pytest.mark.parametrize("edit", ["source", "header", "new_header",
                                  "flags"])
def test_library_name_follows_every_input(csrc, monkeypatch, edit):
    before = {n: _build._lib_path(n) for n in ("a", "b")}
    assert before["a"] != before["b"]
    assert os.path.dirname(before["a"]) == _build.BUILD_DIR
    if edit == "source":
        (csrc / "a.cu").write_text('#include "shared.cuh"\nint a2;\n')
    elif edit == "header":
        (csrc / "shared.cuh").write_text("// helpers, edited\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("// more\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    after = {n: _build._lib_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"]
    # a header or a flag may reach any source; a source only itself
    assert (after["b"] == before["b"]) == (edit == "source")
    assert _build._lib_path("a") == after["a"]       # stable when unchanged
