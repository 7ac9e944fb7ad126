"""Weight carry from the JAX package's variables to the port's state dict:
the inverse of multi_modal_image_fusion_tpu utils/torch_convert.py
(`_conv_w` :27, `_conv`/`_seq` :54-75, the DeepFuse mapping :365-367).

Input is the JAX variables as a nested dict of numpy arrays,
`{"params": {"enc0": {"kernel": HWIO, "bias": ...}, ...}}` (e.g. from
`flax.serialization.msgpack_restore` of a JAX checkpoint). Output is a
`{name: torch.Tensor}` state dict with the reference names and OIHW conv
weights. Conversion fails loudly if a JAX leaf is left unused.
"""

import numpy as np
import torch

__all__ = ["jax_to_state_dict"]

# flax submodule -> reference state-dict prefix, per ported model
_LAYOUTS = {
    "deepfuse": {"enc0": "encode.0", "enc1": "encode.1", "dec0": "decode.0",
                 "dec1": "decode.1", "dec2": "decode.2"},
}


def _oihw(kernel_hwio):
    return np.ascontiguousarray(np.transpose(kernel_hwio, (3, 2, 0, 1)))


def jax_to_state_dict(variables, model_name="deepfuse"):
    """JAX variables (nested numpy dict) -> port state dict (torch)."""
    name = model_name.lower()
    if name not in _LAYOUTS:
        raise NotImplementedError(f"no weight carry for {model_name!r} yet")
    params = dict(variables["params"])
    sd = {}
    for flax_name, prefix in _LAYOUTS[name].items():
        leaf = dict(params.pop(flax_name))
        sd[f"{prefix}.layers.0.weight"] = torch.from_numpy(
            _oihw(np.asarray(leaf.pop("kernel"), np.float32)))
        if "bias" in leaf:
            sd[f"{prefix}.layers.0.bias"] = torch.from_numpy(
                np.array(leaf.pop("bias"), np.float32))
        if leaf:
            raise ValueError(f"unconverted leaves under {flax_name}: "
                             f"{sorted(leaf)}")
    if params:
        raise ValueError(f"unconverted JAX params: {sorted(params)}")
    return sd
