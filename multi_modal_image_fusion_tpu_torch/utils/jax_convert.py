"""Weight carry from the JAX package's variables to the port's state dict:
the inverse of multi_modal_image_fusion_tpu utils/torch_convert.py
(`_conv_w` :27, `_conv`/`_seq` :54-75, `_dense_block` :88-89, `_res2_block`
:109-119, the DeepFuse, DenseFuse, VIFNet and Res2Fusion mappings
:365-377 and :441-445).

Input is the JAX variables as a nested dict of numpy arrays,
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

__all__ = ["jax_to_state_dict", "jax_train_state_to_torch"]


def _res2_block(name, scale):
    """A Res2ConvBlock's convs (their biases absent: use_bias=False); the
    dead `dwconv` set is carried too."""
    return {f"{name}/{conv}": f"{name}.{conv}"
            for conv in ("pwconv1", "dwconv", "pwconv2", "shortcut")} | {
        f"{name}/dwconv{i}": f"{name}.dwconvs.{i}" for i in range(scale)}


# flax submodule path -> reference state-dict prefix, per ported model
_DENSE_ENCODER = {"conv_in": "encode.0",
                  **{f"dense/conv{i}": f"encode.1.layers.{i}"
                     for i in range(3)}}
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
}


def _oihw(kernel_hwio):
    return np.ascontiguousarray(np.transpose(kernel_hwio, (3, 2, 0, 1)))


def jax_to_state_dict(variables, model_name="deepfuse"):
    """JAX variables (nested numpy dict) -> port state dict (torch)."""
    name = model_name.lower()
    if name not in _LAYOUTS:
        raise NotImplementedError(f"no weight carry for {model_name!r} yet")
    params = {k: dict(v) for k, v in variables["params"].items()}
    sd = {}
    for flax_path, prefix in _LAYOUTS[name].items():
        *outer, flax_name = flax_path.split("/")
        parent = params[outer[0]] if outer else params
        leaf = dict(parent.pop(flax_name))
        sd[f"{prefix}.layers.0.weight"] = torch.from_numpy(
            _oihw(np.asarray(leaf.pop("kernel"), np.float32)))
        if "bias" in leaf:
            sd[f"{prefix}.layers.0.bias"] = torch.from_numpy(
                np.array(leaf.pop("bias"), np.float32))
        if leaf:
            raise ValueError(f"unconverted leaves under {flax_name}: "
                             f"{sorted(leaf)}")
    left = sorted(k for k, v in params.items() if v)
    if left:
        raise ValueError(f"unconverted JAX params: {left}")
    return sd


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
