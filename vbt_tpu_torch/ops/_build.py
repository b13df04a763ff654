"""Build the port's CUDA kernels from ``vbt_tpu_torch/csrc`` at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. Nothing includes
PyTorch's headers, so a build takes seconds. Libraries go to
``build/vbt_tpu_torch/`` beside the package (``.gitignore`` lists
``build/``) and are rebuilt when their source is newer. :func:`build_all`
starts one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vbt_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("nms",)  # csrc/<name>.cu -> build/vbt_tpu_torch/lib<name>.so

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels are built on the machine with the card")


def _paths(name: str) -> tuple[Path, Path]:
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), lib


def _finish(name: str, proc: subprocess.Popen, tmp: Path, lib: Path) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a library


def build_all() -> list[str]:
    """Compile every stale kernel source, all ``nvcc`` runs in parallel.
    Returns the names that were (re)built."""
    with _lock:
        started = [(n, *_start(n)) for n in SOURCES if _stale(n)]
        try:
            for name, proc, tmp, lib in started:
                _finish(name, proc, tmp, lib)
        finally:
            for _, proc, tmp, _ in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
        return [s[0] for s in started]


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``lib<name>.so``, built first if stale."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
    if _stale(name):
        build_all()
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _loaded[name]
