"""Read and write flax msgpack checkpoints for the torch modules.

The checkpoints (``models/*.msgpack``) are ``flax.serialization.to_bytes``
of ``{"params": ..., "batch_stats": ...}``. This module reads them without
flax or the ``msgpack`` package: :func:`msgpack_restore` decodes the subset
flax writes (maps, arrays, str, bin, nil/bool, ints, floats, and ext type 1
= ``[shape, dtype name, raw bytes]`` for an ndarray, ext type 3 = the same
for a numpy scalar, stored as a 0-d array).

:func:`convert_flax_variables` renames the flax tree onto the port's
``state_dict``: ``kernel`` -> ``weight`` (HWIO and depthwise ``(kh, kw, 1,
C)`` both become OIHW by ``transpose(3, 2, 0, 1)``), BN ``scale`` ->
``weight``, ``mean``/``var`` -> ``running_mean``/``running_var``, and the
flax auto-name ``BatchNorm_0`` -> ``bn``; a fast-fusion node's weights
(EfficientDet-D's BiFPN) keep their name, ``edge_weight``, in ``params``.
A calibrated pipeline's ``quant`` collection carries one ``act_scale`` leaf
per dense conv; each becomes that conv's ``act_scale`` buffer (a float32
scalar).

The writer is the inverse, so checkpoints stay loadable by both packages:
:func:`msgpack_pack` encodes as ``msgpack.packb`` does (the smallest
format for each value, arrays as ext type 1), :func:`to_flax_variables`
undoes :func:`convert_flax_variables` (OIHW -> HWIO, ``bn`` ->
``BatchNorm_0``, keys sorted as JAX's pytrees sort them), and
:func:`save_params` writes ``flax.serialization.to_bytes`` of the result.
Train checkpoints (:func:`save_train_checkpoint`) keep the JAX package's
layout, ``step_{step:08d}.msgpack`` plus ``LATEST``, each file flax's state
dict of its ``TrainState``: ``step`` (int32), ``params``, ``batch_stats``,
``opt_state`` (optax's chain state; see :func:`_opt_state_tree`) and
``ema_params``.
"""

from __future__ import annotations

import os
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
    ("params", "edge_weight"): "edge_weight",
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


# -- writer ---------------------------------------------------------------------
def _sized(n: int, small: tuple[int, int] | None, markers: tuple[int, int, int]) -> bytes:
    """A msgpack length header: the fix form below ``small[0]`` (marker
    ``small[1] | n``), else 8-, 16- or 32-bit (``markers``, None for none)."""
    if small is not None and n < small[0]:
        return bytes([small[1] | n])
    for marker, fmt, limit in zip(markers, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if marker is not None and n < limit:
            return bytes([marker]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for marker, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < limit:
                return bytes([marker]) + struct.pack(fmt, n)
    for marker, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
        if -limit <= n:
            return bytes([marker]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _pack(obj, out: list) -> None:
    if obj is None or isinstance(obj, bool):
        out.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[obj])
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_sized(len(data), (32, 0xA0), (0xD9, 0xDA, 0xDB)) + data)
    elif isinstance(obj, bytes):
        out.append(_sized(len(obj), None, (0xC4, 0xC5, 0xC6)) + obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), (16, 0x90), (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), (16, 0x80), (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        data = msgpack_pack([list(obj.shape), obj.dtype.name, obj.tobytes()])  # C order
        n = len(data)
        if n in (1, 2, 4, 8, 16):
            head = bytes([0xD4 + n.bit_length() - 1])
        else:
            head = _sized(n, None, (0xC7, 0xC8, 0xC9))
        out.append(head + struct.pack(">b", _EXT_NDARRAY) + data)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def msgpack_pack(obj) -> bytes:
    """Encode nested dicts, lists, scalars and numpy arrays as flax's
    ``msgpack_serialize`` does (dicts in their own order)."""
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _sorted_tree(tree: dict) -> dict:
    return {k: (_sorted_tree(v) if isinstance(v, dict) else v) for k, v in sorted(tree.items())}


def to_flax_variables(state_dict: dict, collections: tuple[str, ...] = ("params", "batch_stats")
                      ) -> dict:
    """The inverse of :func:`convert_flax_variables` for a model
    ``state_dict`` (or a dict of its parameters alone): nested flax
    variables of numpy arrays, the collections in the given order and the
    keys below them sorted. Raises on a key that
    maps to no flax leaf."""
    inverse = {("params", "bias"): "bias", ("params", "edge_weight"): "edge_weight",
               ("batch_stats", "running_mean"): "mean", ("batch_stats", "running_var"): "var"}
    trees: dict = {c: {} for c in collections}
    for key, tensor in state_dict.items():
        *mods, leaf = key.split(".")
        arr = tensor.detach().cpu().numpy()
        if leaf == "weight":
            collection, name = "params", "kernel" if arr.ndim == 4 else "scale"
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        else:
            collection = "params" if leaf in ("bias", "edge_weight") else "batch_stats"
            name = inverse.get((collection, leaf))
        if name is None or collection not in trees:
            raise KeyError(f"{key!r} maps to no flax leaf of {collections}")
        node = trees[collection]
        for m in mods:
            node = node.setdefault("BatchNorm_0" if m == "bn" else m, {})
        node[name] = arr
    return {c: _sorted_tree(trees[c]) for c in collections}


def save_params(path: str, state_dict: dict,
                collections: tuple[str, ...] = ("params", "batch_stats")) -> None:
    """Write a model ``state_dict`` as the flax msgpack checkpoint the JAX
    package writes (``{"params", "batch_stats"}``, in ``collections``'
    order)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_pack(to_flax_variables(state_dict, collections)))


def _check_like(got: dict, template: dict, what: str) -> None:
    if got.keys() != template.keys():
        missing, extra = sorted(template.keys() - got.keys()), sorted(got.keys() - template.keys())
        raise KeyError(f"{what}: missing {missing[:5]}, unexpected {extra[:5]}")
    for k, v in got.items():
        if tuple(v.shape) != tuple(template[k].shape):
            raise ValueError(f"{what}: {k} has shape {tuple(v.shape)}, want "
                             f"{tuple(template[k].shape)}")


def load_params(path: str, template: dict) -> "OrderedDict[str, torch.Tensor]":
    """Read a flax msgpack checkpoint as a ``state_dict`` with the keys and
    shapes of ``template`` (raises otherwise), on its tensors' devices."""
    got = load_checkpoint(path)
    _check_like(got, template, path)
    return OrderedDict((k, got[k].to(template[k].device)) for k in template)


def _opt_state_tree(opt_state, params_tree) -> dict:
    """optax's chain state as flax's state dict: ``[masked(set_to_zero)]``
    (with frozen keys), ``clip_by_global_norm``, ``add_decayed_weights``
    (masked), ``sgd`` = (trace, scale_by_schedule)."""
    parts = ([{"inner_state": {}}] if opt_state.frozen else []) + [
        {}, {"inner_state": {}},
        {"0": {"trace": params_tree}, "1": {"count": np.asarray(opt_state.count, np.int32)}}]
    return {str(i): part for i, part in enumerate(parts)}


def train_state_to_flax(state) -> dict:
    """A port ``TrainState`` as flax's state dict of the JAX ``TrainState``."""
    params = lambda d: to_flax_variables(d, ("params",))["params"]  # noqa: E731
    return {
        "step": np.asarray(state.step, np.int32),
        "params": params(state.params),
        "batch_stats": to_flax_variables(state.batch_stats, ("batch_stats",))["batch_stats"],
        "opt_state": _opt_state_tree(state.opt_state, params(state.opt_state.trace)),
        "ema_params": params(state.ema_params),
    }


def train_state_from_flax(tree: dict, template):
    """flax's state dict of a JAX ``TrainState`` -> a port ``TrainState``
    with ``template``'s keys, shapes, dtypes, devices and freeze (raises on any
    other layout)."""
    def tensors(flax_tree: dict, collection: str, like: dict) -> dict:
        got = convert_flax_variables({collection: flax_tree})
        _check_like(got, like, collection)
        return {k: got[k].to(like[k].device, like[k].dtype) for k in like}

    opt_like = _opt_state_tree(template.opt_state, {})
    opt = tree["opt_state"]
    sgd_key = str(len(opt_like) - 1)
    if set(opt) != set(opt_like) or set(opt[sgd_key]) != {"0", "1"}:
        raise KeyError(f"optimizer state layout {sorted(opt)} is not this trainer's "
                       f"{sorted(opt_like)} (freeze {template.opt_state.frozen})")
    sgd = opt[sgd_key]
    opt_state = type(template.opt_state)(
        tensors(sgd["0"]["trace"], "params", template.opt_state.trace),
        int(sgd["1"]["count"]), template.opt_state.frozen)
    return type(template)(
        int(tree["step"]), tensors(tree["params"], "params", template.params),
        tensors(tree["batch_stats"], "batch_stats", template.batch_stats), opt_state,
        tensors(tree["ema_params"], "params", template.ema_params))


def save_train_checkpoint(ckpt_dir: str, step: int, state) -> None:
    """Mid-training checkpoint: ``step_{step:08d}.msgpack`` plus a LATEST
    marker, readable by the JAX package's ``load_train_checkpoint``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, f"step_{step:08d}.msgpack"), "wb") as f:
        f.write(msgpack_pack(train_state_to_flax(state)))
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(f"{step}\n")


def latest_train_checkpoint(ckpt_dir: str) -> int | None:
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def load_train_checkpoint(ckpt_dir: str, step: int, template):
    """Read ``step_{step:08d}.msgpack`` (either package's) into a port
    ``TrainState`` shaped like ``template``."""
    with open(os.path.join(ckpt_dir, f"step_{step:08d}.msgpack"), "rb") as f:
        return train_state_from_flax(msgpack_restore(f.read()), template)
