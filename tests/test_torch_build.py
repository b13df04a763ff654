"""The port's kernel build helper on the CPU: when a library counts as stale,
and the ctypes helpers every kernel binding uses (:func:`_build.bind`,
:func:`_build.pointers`, :func:`_build.check_layout`).

Nothing is compiled here (no ``nvcc``): the test makes a source, a header and
a library as temporary files, stubs the toolchain (``nvcc --version`` and
the compute capability) and changes the files' contents. A library is named
by a hash of what it is built from (``_build.library_key``), so a changed
source or header asks for a new library; the modification times play no
part (``tests/test_torch_build_cache.py``).
"""

import ctypes
from collections import namedtuple

import pytest

torch = pytest.importorskip("torch")

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


def test_bind_declares_the_c_signature(monkeypatch):
    libc = ctypes.CDLL(None)
    monkeypatch.setattr(_build, "load", lambda name: {"c": libc}[name])
    labs = _build.bind("c", "labs", [ctypes.c_long])
    assert list(labs.argtypes) == [ctypes.c_long] and labs.restype is ctypes.c_int
    assert labs(-3) == 3
    with pytest.raises(ctypes.ArgumentError):
        labs("not a long")


def test_pointers_are_the_tensors_data_pointers():
    tensors = [torch.zeros(3), torch.ones(2, dtype=torch.float64), torch.zeros(1, dtype=torch.bool)]
    array = _build.pointers(tensors)
    assert len(array) == 3 and list(array) == [t.data_ptr() for t in tensors]
    assert _build.pointers(None) is None


_Layout = namedtuple("_Layout", "x valid")


@pytest.mark.parametrize("mismatch", [TypeError, ValueError])
def test_check_layout_refuses_what_the_kernel_cannot_take(mismatch):
    layout = _Layout(torch.empty(2, 3, device="meta"),
                     torch.empty(4, dtype=torch.bool, device="meta"))
    cpu = torch.device("cpu")
    good = _Layout(torch.zeros(2, 3), torch.zeros(4, dtype=torch.bool))

    def check(fields, device=cpu):
        return _build.check_layout("state", fields, layout, device, mismatch)

    assert check(good) == list(good)
    with pytest.raises(mismatch, match=r"state\.valid: the kernel takes torch\.bool \(4,\), got "
                                       r"torch\.float32 \(4,\)"):
        check(good._replace(valid=torch.zeros(4)))
    with pytest.raises(mismatch, match=r"state\.x: the kernel takes torch\.float32 \(2, 3\)"):
        check(good._replace(x=torch.zeros(3, 2)))
    with pytest.raises(ValueError, match=r"state\.x: want a contiguous tensor on cpu"):
        check(good._replace(x=torch.zeros(3, 2).t()))
    with pytest.raises(ValueError, match=r"state\.x: want a contiguous tensor on meta, got cpu"):
        check(good, torch.device("meta"))
