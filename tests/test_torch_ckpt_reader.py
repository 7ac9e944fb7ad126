"""The port's reader of the JAX package's checkpoints (train/checkpoint.py
`msgpack_restore`, `load_jax_checkpoint`, `restore`, `checkpoint_path`),
which imports neither flax, JAX nor msgpack, against
`flax.serialization.msgpack_restore` on files the JAX package's own
`save_checkpoint` writes, on the CPU:

- the committed IFCNN TrainState (tests/torch_fixtures/ifcnn_jax: params,
  batch_stats, an Adam state, the step) and a tree with a bfloat16 leaf,
  0-d leaves, an empty dict, ints past 2^32 and the other msgpack types:
  every leaf equal in dtype, shape and value;
- a truncated file, an unknown ext type and an unknown tag raise;
- the reader works with `msgpack` hidden from `sys.modules`;
- `checkpoint_path` falls back to the `.ckpt` names; `restore` of the
  JAX checkpoint gives `jax_to_state_dict` of its params and statistics,
  nothing missing and nothing unexpected; a checkpoint that lacks a layer
  keeps that layer at init and names it missing, a leaf the layout does
  not take is unexpected.
"""

import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from multi_modal_image_fusion_tpu.train.checkpoint import save_checkpoint
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.train import checkpoint as ckpt
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "ifcnn_jax")
IFCNN = os.path.join(FIXTURE, "epoch_last.ckpt")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same(got, want, where="state"):
    """Every leaf of the port reader's tree equals flax's: the same keys,
    dtype, shape and value (a bfloat16 leaf: a torch tensor against
    flax's ml_dtypes array)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}/{i}")
        return
    if isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32), err_msg=where)
        return
    if isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), (where, type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
        return
    assert type(got) is type(want) and got == want, (where, got, want)


def test_ifcnn_train_state_equals_flax():
    data = _read(IFCNN)
    want = serialization.msgpack_restore(data)
    got = ckpt.load_jax_checkpoint(IFCNN)
    _assert_same(got, want)
    assert set(got) == {"step", "params", "batch_stats", "opt_state"}
    assert got["batch_stats"] and int(got["step"]) == 1


def test_special_leaves_equal_flax(tmp_path):
    tree = {
        "bf16": jnp.asarray([1.5, -2.25, 3.0e38], jnp.bfloat16),
        "bf16_0d": jnp.asarray(0.5, jnp.bfloat16),
        "f32_0d": np.asarray(2.5, np.float32),
        "scalar": np.float64(-1.25),
        "i8": np.arange(-3, 3, dtype=np.int8).reshape(2, 3),
        "u64": np.asarray([2 ** 63 + 5], np.uint64),
        "empty": {},
        "big": 2 ** 40, "neg": -2 ** 35, "huge": 2 ** 64 - 1,
        "small": -5, "byte": 200, "half": 0.5,
        "text": "epoch_best", "flag": True, "off": False, "none": None,
        "cplx": 1.5 - 2j,
        "nested": {"a": {"b": np.zeros((0, 3), np.float32)}},
        "many": {str(i): i for i in range(40)},
        "long_text": "x" * 300,
    }
    path = str(tmp_path / "tree.ckpt")
    save_checkpoint(path, tree)
    want = serialization.msgpack_restore(_read(path))
    got = ckpt.load_jax_checkpoint(path)
    _assert_same(got, want)
    assert got["big"] == 2 ** 40 and got["empty"] == {}


def test_truncated_file_raises(tmp_path):
    data = _read(IFCNN)
    for cut in (1, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError, match="truncated"):
            ckpt.msgpack_restore(data[:cut])
    with pytest.raises(ValueError, match="after the object"):
        ckpt.msgpack_restore(data + b"\x00")


def test_unknown_ext_and_tag_raise():
    # fixext 1 of ext type 9, then the never-used tag 0xc1
    with pytest.raises(ValueError, match="ext type 9"):
        ckpt.msgpack_restore(b"\xd4\x09\x00")
    with pytest.raises(ValueError, match="tag 0xc1"):
        ckpt.msgpack_restore(b"\x81\xa1a\xc1")


def test_reader_works_without_msgpack(monkeypatch):
    """The reader needs no msgpack package (the card machine may have
    none): with `import msgpack` failing, it reads the checkpoint."""
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack  # noqa: F401
    got = ckpt.load_jax_checkpoint(IFCNN)
    assert int(got["step"]) == 1


def test_restore_jax_checkpoint(tmp_path):
    run = tmp_path / "run"
    shutil.copytree(FIXTURE, run)
    path = ckpt.checkpoint_path(str(run))
    assert path.endswith("epoch_last.ckpt")
    want_tree = serialization.msgpack_restore(_read(IFCNN))
    want = jax_to_state_dict({k: want_tree[k]
                              for k in ("params", "batch_stats")}, "ifcnn")
    model = create_model("ifcnn")
    assert ckpt.restore(model, path) == ([], [])
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(v, want[k]), k
    # a .pth beside it comes first
    torch.save(create_model("ifcnn").state_dict(), run / "epoch_last.pth")
    assert ckpt.checkpoint_path(str(run)).endswith("epoch_last.pth")


def test_restore_partial_jax_checkpoint(tmp_path):
    """strict=False: a layer the checkpoint lacks keeps its init and is
    missing; a leaf the layout does not take is unexpected."""
    tree = serialization.msgpack_restore(_read(IFCNN))
    params = {k: v for k, v in tree["params"].items() if k != "dec1"}
    params["extra"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    path = str(tmp_path / "run" / "epoch_best.ckpt")
    save_checkpoint(path, {"step": 0, "params": params,
                           "batch_stats": tree["batch_stats"]},
                    {"model": "ifcnn"})
    model = create_model("ifcnn")
    before = model.decode[1].weight.detach().clone()
    missing, unexpected = ckpt.restore(model, path)
    assert missing and all(k.startswith("decode.1.") for k in missing)
    assert unexpected == ["extra/kernel"]
    assert torch.equal(model.decode[1].weight, before)
