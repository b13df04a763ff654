"""Read flax msgpack checkpoints into ``state_dict``s for the torch modules.

The checkpoints (``models/*.msgpack``) are ``flax.serialization.to_bytes``
of ``{"params": ..., "batch_stats": ...}``; :func:`msgpack_restore` decodes
the subset flax writes without the ``msgpack`` package, and
:func:`convert_flax_variables` renames the flax tree (``kernel`` ->
``weight``, HWIO -> OIHW, BN ``scale`` -> ``weight``, ``mean``/``var`` ->
``running_mean``/``running_var``, ``BatchNorm_0`` -> ``bn``).

Benchmark copy of the port's ``runtime/checkpoint.py``: the reader only.
"""

from __future__ import annotations

import struct
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # marker -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        numbers = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack marker 0x{b:02x} at {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(bytes(self.take(n))).value()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes to nested dicts of numpy arrays."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _leaves(tree: dict, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
    ("quant", "act_scale"): "act_scale",
}
_COLLECTIONS = ("params", "batch_stats", "quant")


def convert_flax_variables(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """Nested flax variables (``params``, ``batch_stats`` and optionally
    ``quant``, numpy leaves) -> a torch ``state_dict`` for
    :class:`EfficientDet`. Raises on an unknown collection or leaf name, or
    on two leaves mapping to one key."""
    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    unknown = set(variables) - set(_COLLECTIONS)
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    for collection in _COLLECTIONS:
        for path, arr in _leaves(variables.get(collection, {})):
            leaf = _LEAF_NAMES.get((collection, path[-1]))
            if leaf is None:
                raise KeyError(f"unexpected leaf {collection}/{'/'.join(path)}")
            mods = ["bn" if p == "BatchNorm_0" else p for p in path[:-1]]
            key = ".".join([*mods, leaf])
            if key in out:
                raise KeyError(f"two checkpoint leaves map onto {key!r}")
            arr = np.asarray(arr)
            if leaf == "weight" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            # A writable C-order copy (the leaf may be a read-only view), shape kept.
            out[key] = torch.from_numpy(np.array(arr, order="C", copy=True).reshape(arr.shape))
    return out


def load_into(model: nn.Module, state_dict: dict) -> nn.Module:
    """Copy ``state_dict`` into ``model``; every key must match one of the
    model's parameters or buffers with the same shape, and none may be left
    over or missing."""
    want = model.state_dict()
    missing = sorted(set(want) - set(state_dict))
    unused = sorted(set(state_dict) - set(want))
    if missing or unused:
        raise KeyError(f"checkpoint mismatch: missing {missing[:5]} ({len(missing)}), "
                       f"unused {unused[:5]} ({len(unused)})")
    for key, tensor in state_dict.items():
        if tuple(tensor.shape) != tuple(want[key].shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{tuple(tensor.shape)} vs model {tuple(want[key].shape)}")
    model.load_state_dict(state_dict, strict=True)
    return model


def load_checkpoint(path: str) -> "OrderedDict[str, torch.Tensor]":
    """Read a flax msgpack checkpoint and convert it to a ``state_dict``."""
    with open(path, "rb") as f:
        return convert_flax_variables(msgpack_restore(f.read()))
