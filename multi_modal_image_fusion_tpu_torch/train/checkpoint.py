"""Checkpoints (counterpart of multi_modal_image_fusion_tpu
train/checkpoint.py) with the reference's best/last semantics (reference
train.py:362-383).

A checkpoint is the model's torch state dict, saved as the reference saves
it (`epoch_best.pth`, `epoch_last.pth`, SURVEY.md 3.1-3.2), with metadata
beside it in `<ckpt>.json` and, for resume, the trainer's optimizer state
(step and Adam moments) in `<ckpt>.optim`. The test CLI and `restore` read
the state dict alone.

The port also reads the JAX package's checkpoints (`epoch_best.ckpt`,
`epoch_last.ckpt`: flax msgpack of the whole TrainState, its
train/checkpoint.py:19-28, with the same `.json` metadata) with neither
flax, JAX nor the `msgpack` package: `msgpack_restore` decodes the subset
of msgpack that `flax.serialization.to_bytes` writes (maps, arrays, str,
bin, nil, bool, ints, floats, and flax's ext types: 1 an ndarray packed as
(shape, dtype name, C-order bytes), 2 a native complex, 3 a numpy scalar),
and raises on any other type or tag. A leaf is a read-only numpy array,
or a torch tensor where the dtype is bfloat16 (numpy has none); a leaf
past 2^30 bytes, which flax writes as a dict of chunks, stays that dict.
"""

import json
import os
import struct

import numpy as np
import torch

__all__ = ["checkpoint_path", "is_jax_checkpoint", "jax_tree",
           "load_checkpoint_meta", "load_jax_checkpoint", "load_train_state",
           "msgpack_restore", "restore", "save_checkpoint", "save_state_dict",
           "to_numpy_tree"]

CKPT_NAMES = ("epoch_best.pth", "epoch_last.pth", "epoch_best.ckpt",
              "epoch_last.ckpt")
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def save_state_dict(path, state_dict, meta=None):
    """Write `path` (torch state dict) and `path`.json (metadata)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=1)


def save_checkpoint(path, model_state, train_state, meta=None):
    """Write `path` (model state dict), `path`.optim (the trainer's
    state_dict(): step and Adam moments) and `path`.json (metadata)."""
    save_state_dict(path, model_state, meta)
    torch.save(train_state, path + ".optim")


def load_train_state(path):
    """The optimizer state saved beside the checkpoint at `path`."""
    return torch.load(path + ".optim", map_location="cpu", weights_only=True)


def load_checkpoint_meta(path):
    meta_path = path + ".json"
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def checkpoint_path(ckpt_dir):
    """epoch_best.pth, else epoch_last.pth, else the JAX package's
    epoch_best.ckpt, else epoch_last.ckpt, under ckpt_dir."""
    for name in CKPT_NAMES:
        path = os.path.join(ckpt_dir, name)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")


def is_jax_checkpoint(path):
    """True for a JAX package checkpoint (flax msgpack, `.ckpt`)."""
    return path.endswith(".ckpt")


def restore(model, path, model_name=None):
    """strict=False restore (reference test.py:176): tensors present in the
    checkpoint replace the model's; the model's other tensors keep their
    init (e.g. the fusion layers when testing a stage-1 autoencoder
    checkpoint); checkpoint-only tensors are dropped. Returns (missing,
    unexpected) key lists. A JAX checkpoint (`is_jax_checkpoint`): its
    TrainState's params and batch_stats, carried by utils/jax_convert's
    layout of `model_name` (default the `.json` metadata's model) in the
    model's configuration (`layout_cfg`); the flax paths the layout does
    not take are unexpected, as the JAX package's merge_variables drops
    them (train/checkpoint.py:46)."""
    if not is_jax_checkpoint(path):
        state = torch.load(path, map_location="cpu", weights_only=True)
        result = model.load_state_dict(state, strict=False)
        return list(result.missing_keys), list(result.unexpected_keys)
    from ..utils.jax_convert import jax_to_state_dict
    tree, name, cfg = jax_tree(path, model, model_name)
    variables = {k: tree[k] for k in ("params", "batch_stats") if tree.get(k)}
    state, left = jax_to_state_dict(variables, name, strict=False, **cfg)
    result = model.load_state_dict(state, strict=False)
    return (list(result.missing_keys),
            list(result.unexpected_keys) + left)


def jax_tree(path, model, model_name=None):
    """(the TrainState tree of a JAX checkpoint as numpy, the model name
    for utils/jax_convert, the model's configuration `layout_cfg`); the
    name is `model_name`, else the `.json` metadata's model."""
    name = model_name or load_checkpoint_meta(path).get("model")
    if name is None:
        raise ValueError(f"{path}: no model name (no .json metadata)")
    return (to_numpy_tree(load_jax_checkpoint(path)), name,
            getattr(model, "layout_cfg", {}))


def load_jax_checkpoint(path):
    """The nested dict a JAX package checkpoint holds (the TrainState's
    step, params, batch_stats, opt_state), as flax's msgpack_restore
    returns it."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def to_numpy_tree(tree):
    """A restored tree's leaves as writable numpy arrays (bfloat16 tensors
    widened to float32), for utils/jax_convert."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def msgpack_restore(data):
    """flax.serialization.msgpack_restore without flax or msgpack: the
    object `data` encodes (module docstring)."""
    obj, end = _Unpacker(memoryview(data)).read(0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} bytes after the "
                         f"object")
    return obj


class _Unpacker:
    """A msgpack decoder of one buffer: `read(pos)` -> (object, next
    position). Str keys and values decode as UTF-8 (`raw=False`), bin as
    bytes, arrays as lists."""

    _FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
              0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
              0xca: ">f", 0xcb: ">d"}

    def __init__(self, buf, raw=False):
        self.buf, self.raw = buf, raw

    def _take(self, pos, n):
        if pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {pos} (needs {n} "
                             f"of {len(self.buf) - pos} left)")
        return self.buf[pos:pos + n], pos + n

    def _uint(self, pos, n):
        raw, pos = self._take(pos, n)
        return int.from_bytes(raw, "big"), pos

    def _str(self, pos, n):
        raw, pos = self._take(pos, n)
        return (bytes(raw) if self.raw else str(raw, "utf-8")), pos

    def _array(self, pos, n):
        out = []
        for _ in range(n):
            v, pos = self.read(pos)
            out.append(v)
        return out, pos

    def _map(self, pos, n):
        out = {}
        for _ in range(n):
            k, pos = self.read(pos)
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack: a map key of type "
                                 f"{type(k).__name__} at byte {pos}")
            out[k], pos = self.read(pos)
        return out, pos

    def _ext(self, pos, n):
        code, pos = self._take(pos, 1)
        code = struct.unpack(">b", code)[0]
        data, pos = self._take(pos, n)
        return _ext_object(code, bytes(data)), pos

    def read(self, pos):
        (b,), pos = self._take(pos, 1)
        if b <= 0x7f:
            return b, pos
        if b >= 0xe0:
            return b - 0x100, pos
        if 0x80 <= b <= 0x8f:
            return self._map(pos, b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(pos, b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self._str(pos, b & 0x1f)
        if b == 0xc0:
            return None, pos
        if b in (0xc2, 0xc3):
            return b == 0xc3, pos
        if b in self._FIXED:
            fmt = self._FIXED[b]
            raw, pos = self._take(pos, struct.calcsize(fmt))
            return struct.unpack(fmt, raw)[0], pos
        if b in (0xc4, 0xc5, 0xc6):                     # bin 8/16/32
            n, pos = self._uint(pos, 1 << (b - 0xc4))
            raw, pos = self._take(pos, n)
            return bytes(raw), pos
        if b in (0xd9, 0xda, 0xdb):                     # str 8/16/32
            n, pos = self._uint(pos, 1 << (b - 0xd9))
            return self._str(pos, n)
        if b in (0xdc, 0xdd):                           # array 16/32
            n, pos = self._uint(pos, 2 << (b - 0xdc))
            return self._array(pos, n)
        if b in (0xde, 0xdf):                           # map 16/32
            n, pos = self._uint(pos, 2 << (b - 0xde))
            return self._map(pos, n)
        if 0xd4 <= b <= 0xd8:                           # fixext 1-16
            return self._ext(pos, 1 << (b - 0xd4))
        if b in (0xc7, 0xc8, 0xc9):                     # ext 8/16/32
            n, pos = self._uint(pos, 1 << (b - 0xc7))
            return self._ext(pos, n)
        raise ValueError(f"msgpack: unknown tag 0x{b:02x} at byte {pos - 1}")


def _ext_object(code, data):
    """flax's ext types (flax/serialization.py `_MsgpackExtType`)."""
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        inner = _Unpacker(memoryview(data), raw=True)
        (shape, dtype, buf), end = inner.read(0)
        if end != len(data):
            raise ValueError("msgpack: bytes after an ndarray")
        arr = _array(tuple(shape), dtype.decode(), buf)
        return arr if code == _EXT_NDARRAY else arr[()]
    if code == _EXT_COMPLEX:
        (re, im), end = _Unpacker(memoryview(data)).read(0)
        if end != len(data):
            raise ValueError("msgpack: bytes after a complex")
        return complex(re, im)
    raise ValueError(f"msgpack: unknown ext type {code}")


def _array(shape, dtype, buf):
    """An ndarray leaf: numpy's dtype of that name, read-only over `buf`;
    bfloat16, which numpy lacks, as a torch tensor."""
    if dtype == "bfloat16":
        t = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) if buf \
            else torch.empty(0, dtype=torch.bfloat16)
        return t.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
