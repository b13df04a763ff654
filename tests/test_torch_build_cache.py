"""The port's kernel build cache on the CPU (``ops._build.library_key``,
``utils.cache.enable_persistent_cache``).

No ``nvcc`` runs: ``nvcc --version`` and the compute capability are
stubbed, and ``build_all`` is held with a stand-in compiler that writes the
output file it is asked for. Held: the key changes with the source, each
header, ``NVCC_FLAGS``, a source's ``SOURCE_FLAGS``, an extra flag that
changes code, the nvcc version string and the compute capability, and not
with a modification time or with ``-Xptxas -v``; two keys never share a
file; ``build_all`` builds nothing when every library of the key exists,
every source again when asked for the ptxas report, and a new file when a
``SOURCE_FLAGS`` entry changes; the build directory follows
``enable_persistent_cache``'s path, its environment override and its
default.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from vbt_tpu_torch.ops import _build  # noqa: E402
from vbt_tpu_torch.utils import cache  # noqa: E402

NVCC = "Cuda compilation tools, release 12.9, V12.9.86"
# A stand-in for nvcc: writes a file at the path after -o.
FAKE_NVCC = ("import sys; a = sys.argv; open(a[a.index('-o') + 1], 'w').write(' '.join(a)); "
             "print('ptxas info: stand-in')")


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "common.cuh", "more.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    toolchain = {"nvcc": NVCC, "cc": "sm_90"}
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "SOURCES", ("a", "b"))
    monkeypatch.setattr(_build, "SOURCE_FLAGS", {"b": ["--fmad=false"]})
    monkeypatch.setattr(_build, "nvcc_version", lambda: toolchain["nvcc"])
    monkeypatch.setattr(_build, "compute_capability", lambda: toolchain["cc"])
    monkeypatch.setattr(_build, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(_build, "NVCC_FLAGS", ["-c", FAKE_NVCC, *_build.NVCC_FLAGS])
    monkeypatch.setattr(_build, "build_log", {})
    return csrc, toolchain


def _edit(path):
    path.write_text(path.read_text() + "// edited\n")


@pytest.mark.parametrize("change", ["source", "header", "other_header", "nvcc_flags",
                                    "source_flags", "extra_flag", "nvcc_version",
                                    "capability"])
def test_key_changes_with_what_builds_the_library(tree, change, monkeypatch):
    csrc, toolchain = tree
    before = _build.library_path("a")
    extra = ()
    if change == "source":
        _edit(csrc / "a.cu")
    elif change == "header":
        _edit(csrc / "common.cuh")
    elif change == "other_header":
        _edit(csrc / "more.cuh")
    elif change == "nvcc_flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    elif change == "source_flags":
        monkeypatch.setitem(_build.SOURCE_FLAGS, "a", ["--fmad=false"])
    elif change == "extra_flag":
        extra = ("-DPROBE=1",)
    elif change == "nvcc_version":
        toolchain["nvcc"] = NVCC.replace("12.9", "13.0")
    elif change == "capability":
        toolchain["cc"] = "sm_100"
    assert _build.library_path("a", extra) != before


def test_key_ignores_mtime_other_sources_and_the_ptxas_report(tree):
    csrc, _ = tree
    key = _build.library_key("a")
    os.utime(csrc / "a.cu", (1, 1))
    os.utime(csrc / "common.cuh", (2e9, 2e9))
    _edit(csrc / "b.cu")  # another kernel's source
    assert _build.library_key("a") == key
    assert _build.library_key("a", _build.PTXAS_VERBOSE) == key
    assert _build.library_key("a", ["-DX", *_build.PTXAS_VERBOSE]) == _build.library_key("a", ["-DX"])
    assert _build.library_key("b") != key  # two sources never share a file
    assert _build.library_path("a").name == f"liba-{key}.so"


def test_build_all_builds_what_is_missing(tree, monkeypatch):
    csrc, _ = tree
    assert _build.build_all() == ["a", "b"]
    assert _build.build_all() == []  # every library of the key exists
    assert not _build._stale("a") and not _build._stale("b")
    # The ptxas report: every source again, into the same files.
    first = {n: _build.library_path(n) for n in ("a", "b")}
    assert _build.build_all(_build.PTXAS_VERBOSE) == ["a", "b"]
    assert "-Xptxas -v" in first["a"].read_text() and "ptxas info" in _build.build_log["a"]
    assert {n: _build.library_path(n) for n in ("a", "b")} == first
    # A changed SOURCE_FLAGS entry: a new key, a new file beside the old one.
    monkeypatch.setitem(_build.SOURCE_FLAGS, "a", ["--fmad=false", "-DPROBE=1"])
    assert _build.build_all() == ["a"]
    assert _build.library_path("a") != first["a"] and first["a"].exists()
    assert "-DPROBE=1" in _build.library_path("a").read_text()
    # A changed source: rebuilt.
    _edit(csrc / "b.cu")
    assert _build.build_all() == ["b"]


def test_build_failure_raises_and_leaves_no_library(tree, monkeypatch):
    monkeypatch.setattr(_build, "NVCC_FLAGS", ["-c", "import sys; sys.exit('nope')"])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all()
    assert not list(_build.BUILD_DIR.glob("*.so"))


def test_enable_persistent_cache_selects_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv(cache.ENV_DIR, raising=False)
    assert cache.enable_persistent_cache(tmp_path / "given") == tmp_path / "given"
    assert _build.BUILD_DIR == tmp_path / "given" and (tmp_path / "given").is_dir()
    monkeypatch.setenv(cache.ENV_DIR, str(tmp_path / "env"))
    assert cache.enable_persistent_cache() == tmp_path / "env" == _build.BUILD_DIR
    monkeypatch.delenv(cache.ENV_DIR)
    assert cache.enable_persistent_cache() == cache.DEFAULT_DIR == _build.BUILD_DIR
    assert cache.DEFAULT_DIR.parts[-2:] == ("build", "vbt_tpu_torch")


def test_nvcc_version_is_asked_of_the_compiler(monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=NVCC)

    monkeypatch.setattr(_build, "_nvcc", lambda: "fake-cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    _build.nvcc_version.cache_clear()
    try:
        assert _build.nvcc_version() == NVCC and _build.nvcc_version() == NVCC
    finally:
        _build.nvcc_version.cache_clear()
    assert calls == [["fake-cuda/bin/nvcc", "--version"]]  # once a process
