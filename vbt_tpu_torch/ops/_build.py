"""Build the port's CUDA kernels from ``vbt_tpu_torch/csrc`` at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. Nothing includes
PyTorch's headers, so a build takes seconds. :func:`build_all` starts one
``nvcc`` per source at once and keeps each compiler's output in
:data:`build_log`.

The build cache is keyed (:func:`library_key`): ``lib<name>-<key>.so`` is
named by a hash of everything that decides its code, namely its ``.cu``
source, every ``.cuh`` header of ``csrc/`` (a source may include any of
them), :data:`NVCC_FLAGS`, its :data:`SOURCE_FLAGS`, the extra flags that
change code, ``nvcc --version`` and the card's compute capability. A
library whose file exists is up to date; a change of any of these builds a
new file beside the old one, and modification times play no part. The
directory is :data:`BUILD_DIR`, ``build/vbt_tpu_torch/`` beside the package
(``.gitignore`` lists ``build/``) unless
:func:`vbt_tpu_torch.utils.cache.enable_persistent_cache` selects another.

A binding declares its launch function's C signature with :func:`bind`,
passes arrays of device pointers with :func:`pointers` and checks a state
of many tensors against the layout its kernel takes with
:func:`check_layout`.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vbt_tpu_torch"
BUILD_DIR = DEFAULT_BUILD_DIR  # set by utils.cache.enable_persistent_cache
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# csrc/<name>.cu -> <BUILD_DIR>/lib<name>-<key>.so
SOURCES = ("nms", "fused_mbconv", "fused_mbconv_mma", "track_scan", "analysis_scan",
           "batchnorm_act")
# Flags of one source after the standard ones. The tracker and the analysis
# scan round each multiply and add apart, as their plain versions' CPU
# kernels do.
SOURCE_FLAGS = {"track_scan": ["--fmad=false"], "analysis_scan": ["--fmad=false"]}
# Registers, spills and shared memory of every kernel: a report, not a code
# change, so it is left out of the key, and a build asked for with it runs
# even where the library is up to date.
PTXAS_VERBOSE = ["-Xptxas", "-v"]

build_log: dict[str, str] = {}  # nvcc's output of the last build of each source

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


@functools.cache
def nvcc_version() -> str:
    """``nvcc --version`` of the toolkit that builds the kernels."""
    return subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout


def compute_capability() -> str:
    """The current card's compute capability, as ``sm_<major><minor>``."""
    import torch

    major, minor = torch.cuda.get_device_capability()
    return f"sm_{major}{minor}"


def _code_flags(extra_flags) -> list[str]:
    """``extra_flags`` without :data:`PTXAS_VERBOSE`, which changes no code."""
    flags, n, i = list(extra_flags), len(PTXAS_VERBOSE), 0
    out = []
    while i < len(flags):
        if flags[i:i + n] == PTXAS_VERBOSE:
            i += n
        else:
            out.append(flags[i])
            i += 1
    return out


def library_key(name: str, extra_flags=()) -> str:
    """The hash that names ``lib<name>-<key>.so``: the source, every header,
    the flags that change code, the nvcc version and the compute capability."""
    h = hashlib.sha256()

    def part(label: str, data: bytes) -> None:
        h.update(label.encode() + b"\0" + len(data).to_bytes(8, "little") + data)

    part(f"{name}.cu", (CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        part(header.name, header.read_bytes())
    part("flags", json.dumps([NVCC_FLAGS, SOURCE_FLAGS.get(name, []),
                              _code_flags(extra_flags)]).encode())
    part("nvcc", nvcc_version().encode())
    part("capability", compute_capability().encode())
    return h.hexdigest()[:16]


def library_path(name: str, extra_flags=()) -> Path:
    """Where the library of ``name`` built with ``extra_flags`` lives."""
    return BUILD_DIR / f"lib{name}-{library_key(name, extra_flags)}.so"


def _stale(name: str) -> bool:
    """Whether the library of ``name``'s current key has not been built."""
    return not library_path(name).exists()


def _start(name: str, extra_flags: tuple[str, ...]) -> tuple[subprocess.Popen, Path, Path]:
    src, lib = CSRC / f"{name}.cu", library_path(name, extra_flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), *extra_flags, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), lib


def _finish(name: str, proc: subprocess.Popen, tmp: Path, lib: Path) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{out}")
    build_log[name] = out
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a library


def build_all(extra_flags: tuple[str, ...] | list[str] = ()) -> list[str]:
    """Compile every kernel source whose library of this key is missing, all
    ``nvcc`` runs in parallel, with ``extra_flags`` after the standard ones.
    With :data:`PTXAS_VERBOSE` among them every source is compiled, so that
    :data:`build_log` holds the report. Returns the names that were built."""
    extra = tuple(extra_flags)
    report = list(extra) != _code_flags(extra)
    with _lock:
        started = [(n, *_start(n, extra)) for n in SOURCES
                   if report or not library_path(n, extra).exists()]
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
    """The kernel library of ``name``, built first if its key has none."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
    if _stale(name):
        build_all()
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def bind(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The launch function ``symbol`` of ``name``'s library (:func:`load`),
    its C signature declared: ``argtypes`` in, a ``cudaError_t`` (an int)
    out."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def pointers(tensors) -> ctypes.Array | None:
    """The data pointers of ``tensors`` as a C array (None for None)."""
    if tensors is None:
        return None
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def check_layout(kind: str, fields, layout, device, mismatch: type[Exception] = TypeError) -> list:
    """The tensors of the named tuple ``fields`` (``kind`` names it in the
    errors), checked against ``layout``, the same named tuple of the shapes
    and dtypes the kernel takes: another shape or dtype raises ``mismatch``,
    a tensor not contiguous on ``device`` ``ValueError``."""
    for name, t, want in zip(fields._fields, fields, layout):
        if t.dtype != want.dtype or t.shape != want.shape:
            raise mismatch(f"{kind}.{name}: the kernel takes {want.dtype} {tuple(want.shape)}, "
                           f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{kind}.{name}: want a contiguous tensor on {device}, got "
                             f"{t.device}, strides {t.stride()}")
    return list(fields)
