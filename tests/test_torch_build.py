"""The kernel build's cache key (ops/_build.py), on the CPU: no nvcc.

A library is named by a hash of its source, of every shared header in
``csrc/`` and of the nvcc flags, so an edit to any of them must give a
new library path (and so a rebuild), and nothing else may.
"""

import pytest

from classmate_rag_tpu_torch.ops import _build


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "one.cu").write_text('#include "shared.cuh"\nint one() { return 1; }\n')
    (src / "two.cu").write_text("int two() { return 2; }\n")
    (src / "shared.cuh").write_text("#pragma once\nconstexpr int W = 64;\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("edit", [
    ("shared.cuh", "#pragma once\nconstexpr int W = 128;\n"),   # a header
    ("extra.cuh", "#pragma once\n"),                            # a new header
    ("one.cu", '#include "shared.cuh"\nint one() { return 3; }\n'),
])
def test_edit_changes_library_path(csrc, edit):
    before = _build._lib_path("one")
    name, text = edit
    (csrc / name).write_text(text)
    after = _build._lib_path("one")
    assert after != before
    assert after.parent == before.parent == _build.BUILD_DIR
    assert after.name.startswith("one-") and after.suffix == ".so"


def test_unchanged_tree_keeps_library_path(csrc):
    first = {n: _build._lib_path(n) for n in _build.sources()}
    assert sorted(first) == ["one", "two"]      # headers are not sources
    assert first == {n: _build._lib_path(n) for n in _build.sources()}
    (csrc / "notes.txt").write_text("not a header")
    assert first == {n: _build._lib_path(n) for n in _build.sources()}


def test_real_sources_hash_the_shared_header():
    """The port's sources include csrc/hopper.cuh; it is in every key."""
    assert (_build.CSRC / "hopper.cuh").exists()
    for name in ("flash_attn", "topk_scan"):
        assert '#include "hopper.cuh"' in (
            _build.CSRC / f"{name}.cu").read_text()
    assert "flash_attn" in _build.sources() and "hopper" not in _build.sources()


def test_install_ships_every_package_and_kernel_file():
    """pyproject.toml lists every package of the port, ships every file
    the kernels build from (sources and the shared header) and names the
    port's command line."""
    import fnmatch
    import tomllib
    from pathlib import Path

    root = Path(_build.__file__).resolve().parents[2]
    meta = tomllib.loads((root / "pyproject.toml").read_text())
    listed = set(meta["tool"]["setuptools"]["packages"])
    port = root / "classmate_rag_tpu_torch"
    packages = {".".join(p.parent.relative_to(root).parts)
                for p in port.rglob("__init__.py")}
    assert packages and packages <= listed, packages - listed
    globs = meta["tool"]["setuptools"]["package-data"][
        "classmate_rag_tpu_torch.ops"]
    for f in _build.CSRC.iterdir():
        assert any(fnmatch.fnmatch(f"csrc/{f.name}", g) for g in globs), f
    assert meta["project"]["scripts"]["rag-torch"] == (
        "classmate_rag_tpu_torch.cli.main:main")
