"""The kernel build cache, the port's counterpart of the persistent compile cache.

The JAX package keeps XLA's persistent compilation cache
(``vbt_tpu.utils.cache``), with CPU artifacts keyed by the host's CPU
features. The port compiles no graphs; what it builds are its CUDA kernel
libraries (:mod:`vbt_tpu_torch.ops._build`), and both roles map onto that
build cache: every library is keyed by its source, the headers, the flags,
the ``nvcc`` version and the card's compute capability
(:func:`~vbt_tpu_torch.ops._build.library_key`), so one directory serves
any toolkit and card without a stale library. Every port CLI calls
:func:`enable_persistent_cache` before it touches the card.
"""

from __future__ import annotations

import os
from pathlib import Path

from vbt_tpu_torch.ops import _build

ENV_DIR = "VBT_TORCH_BUILD_DIR"  # overrides the default directory
DEFAULT_DIR = _build.DEFAULT_BUILD_DIR  # build/vbt_tpu_torch/ beside the package


def enable_persistent_cache(path: str | os.PathLike | None = None) -> Path:
    """Select the kernel build directory: ``path``, else ``$VBT_TORCH_BUILD_DIR``,
    else ``build/vbt_tpu_torch/`` beside the package. Returns it."""
    cache_dir = Path(path or os.environ.get(ENV_DIR) or DEFAULT_DIR)
    cache_dir.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = cache_dir
    return cache_dir
