"""The port's kernel build helper on the CPU: when a library counts as stale.

Nothing is compiled here (no ``nvcc``): the test makes a source, a header and
a library as temporary files, stubs the toolchain (``nvcc --version`` and
the compute capability) and changes the files' contents. A library is named
by a hash of what it is built from (``_build.library_key``), so a changed
source or header asks for a new library; the modification times play no
part (``tests/test_torch_build_cache.py``).
"""

import pytest

pytest.importorskip("torch")

from vbt_tpu_torch.ops import _build  # noqa: E402


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "nvcc_version", lambda: "Cuda compilation tools, release 12.9")
    monkeypatch.setattr(_build, "compute_capability", lambda: "sm_90")
    src, header, other = csrc / "k.cu", csrc / "common.cuh", csrc / "other.cu"
    for path in (src, header, other):
        path.write_text(f"// {path.name}\n")
    return src, header, other


@pytest.mark.parametrize("newer,stale", [
    (None, False),       # nothing it is built from changed
    ("src", True),       # its own .cu changed
    ("header", True),    # a .cuh it may include changed
    ("other", False),    # another kernel's .cu is not built into it
])
def test_stale_looks_at_source_and_headers(tree, newer, stale):
    src, header, other = tree
    assert _build._stale("k")  # no library yet
    _build.library_path("k").write_text("")
    assert not _build._stale("k")
    if newer:
        path = {"src": src, "header": header, "other": other}[newer]
        path.write_text(path.read_text() + "// changed\n")
    assert _build._stale("k") is stale


def test_every_source_is_in_the_package():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file(), name
