"""The kernel build's cache key (``ops/_build.library_path``), on the CPU.

No nvcc is needed: the key is a hash of the kernel's source, every
``*.cu`` / ``*.cuh`` in the source directory (what an ``#include`` can
reach) and ``NVCC_FLAGS``. An edited header or flag must name another
library, or a stale ``.so`` would load.
"""

import pytest

from tfservingcache_tpu_torch.ops import _build


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "common.cuh"\nint tpusc_kern() { return ONE; }\n')
    (src / "common.cuh").write_text("#define ONE 1\n")
    (src / "other.cu").write_text("int tpusc_other() { return 2; }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_library_path_is_stable_for_an_unchanged_tree(csrc):
    first = _build.library_path("kern")
    assert first == _build.library_path("kern")
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("libkern-") and first.suffix == ".so"
    assert _build.library_path("other") != first


@pytest.mark.parametrize("edited", ["common.cuh", "kern.cu", "other.cu"])
def test_editing_a_source_or_header_changes_library_path(csrc, edited):
    before = _build.library_path("kern")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert _build.library_path("kern") != before


def test_a_new_header_changes_library_path(csrc):
    before = _build.library_path("kern")
    (csrc / "extra.cuh").write_text("#define TWO 2\n")
    assert _build.library_path("kern") != before


def test_changing_a_flag_changes_library_path(csrc, monkeypatch):
    before = _build.library_path("kern")
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.library_path("kern") != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", tuple(f for f in _build.NVCC_FLAGS if f != "-lineinfo"))
    assert _build.library_path("kern") == before


def test_files_that_no_include_reaches_do_not_change_library_path(csrc):
    before = _build.library_path("kern")
    (csrc / "notes.txt").write_text("not a source\n")
    assert _build.library_path("kern") == before


def test_build_skips_a_library_that_exists(csrc, monkeypatch):
    """A built key loads as it is: no nvcc is looked up or started."""
    out = _build.library_path("kern")
    out.parent.mkdir(parents=True)
    out.write_bytes(b"")

    def no_nvcc():
        raise AssertionError("nvcc started for a built library")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.build(("kern",)) == {"kern": out}
