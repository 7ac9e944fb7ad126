"""Weight carry from the JAX package's variables to the port's state dict:
the inverse of multi_modal_image_fusion_tpu utils/torch_convert.py
(`_conv_w` :27, `_conv`/`_seq` :54-75, `_dense_block` :88-89, `_conv_block`
:92-95, `_rfn` :98-106, `_res2_block` :109-119, `_nest_decoder` :223-225,
the DeepFuse, DenseFuse, VIFNet, DBNet, Res2Fusion, NestFuse, RFNNest,
MAFusion and UNFusion mappings :365-384 and :441-478).

Input is the JAX variables as a nested dict of numpy arrays, to any depth,
`{"params": {"enc0": {"kernel": HWIO, "bias": ...}, ...}}` (e.g. from
`flax.serialization.msgpack_restore` of a JAX checkpoint). Output is a
`{name: torch.Tensor}` state dict with the reference names and OIHW conv
weights. Conversion fails loudly if a JAX leaf is left unused.

`jax_train_state_to_torch` carries a whole JAX TrainState (train/trainer.py:
29: step, params, batch_stats, and the optax chain's state with Adam's
mu, nu and count) to the port's state dict and the port Trainer's
optimizer state (`Trainer.load_state_dict`).
"""

import numpy as np
import torch

__all__ = ["flax_paths", "jax_to_state_dict", "jax_train_state_to_torch"]


def _res2_block(name, scale):
    """A Res2ConvBlock's convs (their biases absent: use_bias=False); the
    dead `dwconv` set is carried too."""
    return {f"{name}/{conv}": f"{name}.{conv}"
            for conv in ("pwconv1", "dwconv", "pwconv2", "shortcut")} | {
        f"{name}/dwconv{i}": f"{name}.dwconvs.{i}" for i in range(scale)}


def _dense_block(name, prefix):
    return {f"{name}/conv{i}": f"{prefix}.layers.{i}" for i in range(3)}


def _conv_block(name, prefix):
    """ConvBlock / ECB / DCB: conv1, conv2 -> layers.0, layers.1."""
    return {f"{name}/conv{i + 1}": f"{prefix}.layers.{i}" for i in range(2)}


def _unfusion():
    """UNFusion in stride mode (maxpool mode has no down convs: their
    entries are skipped when the JAX tree lacks them)."""
    m = {"conv_out": "conv_out",
         **{f"CB{i}_0": f"CB{i}_0" for i in range(1, 5)},
         **{f"down{i}": f"down{i}" for i in (1, 2, 3)},
         **{f"encode/down{i}": f"encode.down{i}" for i in (1, 2, 3)}}
    for n in ("EB2_1", "EB3_1", "EB4_1", "EB3_2", "EB4_2", "EB4_3"):
        m |= _conv_block(f"encode/{n}", f"encode.{n}")
    for n in ("DB1_1", "DB2_1", "DB3_1", "DB1_2", "DB2_2", "DB1_3"):
        m |= _conv_block(f"decode/{n}", f"decode.{n}")
    return m


def _rfn(name):
    """An RFN: res, conv1, conv2 keep their names, fuse1-3 -> layers.0-2."""
    return {f"{name}/{conv}": f"{name}.{conv}"
            for conv in ("res", "conv1", "conv2")} | {
        f"{name}/fuse{i + 1}": f"{name}.layers.{i}" for i in range(3)}


def _nest(decoder_blocks, rfn=False):
    """NestFuse, RFNNest and MAFusion in stride mode (maxpool mode has no
    down convs: their entries are skipped when the JAX tree lacks them)."""
    m = {"conv_in": "conv_in", "conv_out": "conv_out",
         **{f"down{i}": f"down{i}" for i in (1, 2, 3)}}
    for i in range(1, 5):
        m |= _conv_block(f"CB{i}_0", f"CB{i}_0")
        if rfn:
            m |= _rfn(f"RFN{i}")
    for n in decoder_blocks:
        m |= _conv_block(f"decode/{n}", f"decode.{n}")
    return m


_NEST_DECODER = ("DB1_1", "DB2_1", "DB3_1", "DB1_2", "DB2_2", "DB1_3")

# flax submodule path -> reference state-dict prefix, per ported model
_DENSE_ENCODER = {"conv_in": "encode.0", **_dense_block("dense", "encode.1")}
_DOWNS = {f"down{i}" for i in (1, 2, 3)}
_OPTIONAL = {"unfusion": _DOWNS | {f"encode/{d}" for d in _DOWNS},
             "nestfuse": _DOWNS, "rfnnest": _DOWNS, "mafusion": _DOWNS}
_LAYOUTS = {
    "deepfuse": {"enc0": "encode.0", "enc1": "encode.1", "dec0": "decode.0",
                 "dec1": "decode.1", "dec2": "decode.2"},
    "densefuse": {**_DENSE_ENCODER,
                  **{f"dec{i}": f"decode.{i}" for i in range(4)}},
    "vifnet": {**_DENSE_ENCODER,
               **{f"dec{i}": f"decode.{i}" for i in range(5)}},
    "res2fusion": {"conv_in": "conv_in",
                   **_res2_block("RB1", 4), **_res2_block("RB2", 8),
                   **{f"dec{i}": f"decode.{i}" for i in range(4)}},
    "dbnet": {"conv_in": "encode", "detail0": "detail.0",
              **_dense_block("detail1", "detail.1"),
              **{f"semantic{i}": f"semantic.{i}" for i in range(3)},
              **{f"dec{i}": f"decode.{i}" for i in range(4)}},
    "unfusion": _unfusion(),
    "nestfuse": _nest(_NEST_DECODER),
    "rfnnest": _nest(_NEST_DECODER, rfn=True),
    "mafusion": _nest(("DB1", "DB2", "DB3")),
}


def flax_paths(model_name):
    """{port module name: '/'-joined flax path} of a model's conv layers,
    the inverse of its layout: the keys int8 calibration records under
    (ops/quant.py), as the JAX package's `calibrate` does."""
    name = model_name.lower()
    if name not in _LAYOUTS:
        raise NotImplementedError(f"no layout for {model_name!r} yet")
    return {prefix: path for path, prefix in _LAYOUTS[name].items()}


def _oihw(kernel_hwio):
    return np.ascontiguousarray(np.transpose(kernel_hwio, (3, 2, 0, 1)))


def jax_to_state_dict(variables, model_name="deepfuse"):
    """JAX variables (nested numpy dict) -> port state dict (torch)."""
    name = model_name.lower()
    if name not in _LAYOUTS:
        raise NotImplementedError(f"no weight carry for {model_name!r} yet")
    params = _copy_tree(variables["params"])
    sd = {}
    for flax_path, prefix in _LAYOUTS[name].items():
        *outer, flax_name = flax_path.split("/")
        parent = params
        for key in outer:
            parent = parent[key]
        if flax_name not in parent and flax_path in _OPTIONAL.get(name, ()):
            continue
        leaf = parent.pop(flax_name)
        sd[f"{prefix}.layers.0.weight"] = torch.from_numpy(
            _oihw(np.asarray(leaf.pop("kernel"), np.float32)))
        if "bias" in leaf:
            sd[f"{prefix}.layers.0.bias"] = torch.from_numpy(
                np.array(leaf.pop("bias"), np.float32))
        if leaf:
            raise ValueError(f"unconverted leaves under {flax_name}: "
                             f"{sorted(leaf)}")
    left = _leaf_paths(params)
    if left:
        raise ValueError(f"unconverted JAX params: {left}")
    return sd


def _copy_tree(tree):
    """The nested dicts of a JAX tree copied (the arrays shared)."""
    return {k: _copy_tree(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


def _leaf_paths(tree, prefix=""):
    """Slash-joined paths of the arrays left in a nested dict."""
    out = []
    for k, v in sorted(tree.items()):
        path = f"{prefix}{k}"
        out += (_leaf_paths(v, path + "/") if hasattr(v, "items")
                else [path])
    return out


def jax_train_state_to_torch(state, model_name="deepfuse"):
    """A JAX TrainState as a nested dict of numpy arrays (e.g.
    `flax.serialization.msgpack_restore` of a JAX `epoch_last.ckpt`) ->
    (port state dict, port optimizer state {"step", "mu", "nu"}).

    The optax chain's state is a dict of its transforms' states ("0", "1",
    ...): one Adam state (count, mu, nu), optional schedule states (count)
    and empty clip states. Every count and the step must agree; any other
    leaf raises."""
    state = dict(state)
    step = int(np.asarray(state.pop("step")))
    params = state.pop("params")
    if state.pop("batch_stats", None):
        raise ValueError(f"{model_name} has no batch statistics to carry")
    opt = state.pop("opt_state")
    if state:
        raise ValueError(f"unconverted TrainState fields: {sorted(state)}")
    adam, counts = None, []
    for key in sorted(opt):
        entry = dict(opt[key])
        if "mu" in entry or "nu" in entry:
            if adam is not None:
                raise ValueError("more than one Adam state in opt_state")
            adam = entry
        elif set(entry) == {"count"}:
            counts.append(int(np.asarray(entry.pop("count"))))
        elif entry:
            raise ValueError(f"unconverted optimizer state {key}: "
                             f"{sorted(entry)}")
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in opt_state")
    counts.append(int(np.asarray(adam.pop("count"))))
    mu = jax_to_state_dict({"params": adam.pop("mu")}, model_name)
    nu = jax_to_state_dict({"params": adam.pop("nu")}, model_name)
    if adam:
        raise ValueError(f"unconverted Adam leaves: {sorted(adam)}")
    if any(c != step for c in counts):
        raise ValueError(f"optimizer counts {counts} differ from step {step}")
    return (jax_to_state_dict({"params": params}, model_name),
            {"step": step, "mu": mu, "nu": nu})
