"""The kernel build cache (``distkeras_torch._build``), without nvcc: a
library's name follows its source and every header it may include."""

import shutil

from distkeras_torch import _build


def _tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "common.cuh"\n// a\n')
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return csrc


def test_digest_follows_source_and_headers(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, monkeypatch)
    a0, b0 = _build.source_digest("a"), _build.source_digest("b")
    assert a0 != b0
    assert _build.source_digest("a") == a0  # stable while nothing changes
    (csrc / "common.cuh").write_text("// v2\n")
    a1 = _build.source_digest("a")
    assert a1 != a0 and _build.source_digest("b") != b0
    (csrc / "extra.cuh").write_text("// new header\n")
    assert _build.source_digest("a") not in (a0, a1)
    (csrc / "extra.cuh").unlink()
    assert _build.source_digest("a") == a1
    (csrc / "a.cu").write_text('#include "common.cuh"\n// a, edited\n')
    assert _build.source_digest("a") != a1
    assert _build.library_path("a").name == f"liba_{_build.source_digest('a')}.so"


def test_headers_are_not_libraries(tmp_path, monkeypatch):
    _tree(tmp_path, monkeypatch)
    assert _build.sources() == ["a", "b"]


def test_flash_libraries_follow_the_mma_header(tmp_path, monkeypatch):
    """An edit of the package's flash_mma.cuh renames both flash libraries."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.source_digest(n) for n in ("flash_fwd", "flash_bwd")}
    header = csrc / "flash_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, digest in before.items():
        assert _build.source_digest(name) != digest, name


def test_flash_libraries_follow_the_hopper_header(tmp_path, monkeypatch):
    """An edit of the package's hopper.cuh (TMA, mbarriers, wgmma: B1 and
    B2) renames both flash libraries."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.source_digest(n) for n in ("flash_fwd", "flash_bwd")}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, digest in before.items():
        assert _build.source_digest(name) != digest, name
