"""The JAX package's native host ops for the port's tests, built when the
package's own build left them out.

``vbt_tpu.native`` builds ``_hostops`` in place at its first import; when
several test workers import it at once on a tree without the library,
their builds write the same file and an import can fail, leaving
``hostops = None`` (and the JAX host lane on scipy, whose tie choices
differ). :func:`native_hostops` then compiles ``csrc/hostops.cpp`` with the
flags of ``vbt_tpu/native/build_ext.py`` into a directory of its own, loads
it, and puts it in ``vbt_tpu.native.hostops`` for the module's tests. It
skips only where there is no C++ compiler.
"""

import importlib.util
import os
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest

import vbt_tpu.native as native

SOURCE = os.path.join(os.path.dirname(native.__file__), "csrc", "hostops.cpp")


def build_hostops(out_dir):
    """Compile and load ``_hostops`` in ``out_dir``; None without a compiler."""
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        return None
    obj = os.path.join(out_dir, "hostops.o")
    lib = os.path.join(out_dir, f"_hostops{sysconfig.get_config_var('EXT_SUFFIX')}")
    includes = [f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}"]
    for cmd in ([cxx, "-O3", "-fPIC", "-std=c++17", *includes, "-c", SOURCE, "-o", obj],
                [cxx, "-shared", obj, "-o", lib]):
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    spec = importlib.util.spec_from_file_location("_hostops", lib)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def native_hostops(tmp_path_factory):
    """``vbt_tpu.native.hostops``: the package's own build, else one made here."""
    module = native.hostops or build_hostops(str(tmp_path_factory.mktemp("hostops")))
    if module is None:
        pytest.skip("no C++ compiler to build the JAX package's native host ops")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "hostops", module)
        yield module
