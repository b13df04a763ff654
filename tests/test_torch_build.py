"""The port's kernel build helper on the CPU: when a library counts as stale.

Nothing is compiled here (no ``nvcc``): the test makes a source, a header and
a library as empty temporary files and moves their modification times.
"""

import os

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
    src, header, other, lib = (csrc / "k.cu", csrc / "common.cuh", csrc / "other.cu",
                               build / "libk.so")
    for path in (src, header, other):
        path.write_text("")
    return src, header, other, lib


def _touch(path, t):
    os.utime(path, (t, t))


@pytest.mark.parametrize("newer,stale", [
    (None, False),       # the library is the newest file
    ("src", True),       # its own .cu changed
    ("header", True),    # a .cuh it may include changed
    ("other", False),    # another kernel's .cu is not built into it
])
def test_stale_looks_at_source_and_headers(tree, newer, stale):
    src, header, other, lib = tree
    assert _build._stale("k")  # no library yet
    lib.write_text("")
    for path in (src, header, other):
        _touch(path, 1000)
    _touch(lib, 2000)
    if newer:
        _touch({"src": src, "header": header, "other": other}[newer], 3000)
    assert _build._stale("k") is stale


def test_every_source_is_in_the_package():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file(), name
