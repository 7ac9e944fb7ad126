"""Every conv that the int8 gate sends to conv_int8 has a plan of the s8
`wgmma` body, and the gate sends the JAX package's layers: for each model
and configuration of the int8 tests (tests/test_torch_int8_common.py
CONFIGS), at the widths the bench runs, pure Python on the CPU.

- `pick_bn_int8` returns a block of the built instances (INT8_INSTANCES)
  for each admitted layer, writing f32 (the test CLI) and bf16 (the
  bench), as `Int8Weights.get` asks it for a float input;
- the layers the port admits are, by flax path, those that the JAX
  package's gate admits (ops/layers.py:628-634: stride 1, groups 1,
  dilation 1, not transposed, pad k // 2), read off the JAX model's
  ConvLayer calls in an abstract trace (`jax.eval_shape`, no compile);
  the layers it keeps float (depthwise convs, strided and VALID downs,
  the Attention's pools, transpose convs) are the rest.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as flax_nn

import test_torch_int8_common as common

from multi_modal_image_fusion_tpu.ops.layers import ConvLayer as JConvLayer
from multi_modal_image_fusion_tpu_torch.ops import quant
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import \
    pick_bn_int8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with common.one_thread():
        yield


def _jax_gate(m):
    pad = m.ksize // 2 if m.padding is None else m.padding
    return (m.stride == 1 and m.groups == 1 and m.dilation == 1
            and not m.transpose and pad == m.ksize // 2)


@functools.lru_cache(maxsize=None)
def _jax_gates(key):
    """{flax path: the JAX gate's verdict} of every ConvLayer the JAX
    forward calls."""
    jm, variables = common.jax_model(key)
    gates = {}

    def intercept(next_fun, args, kwargs, context):
        m = context.module
        if isinstance(m, JConvLayer) and context.method_name == "__call__":
            gates["/".join(m.path)] = _jax_gate(m)
        return next_fun(*args, **kwargs)
    x = jax.ShapeDtypeStruct((1, 64, 64, 1), jnp.float32)
    with flax_nn.intercept_methods(intercept):
        jax.eval_shape(functools.partial(jm.apply, train=False), variables,
                       x, x)
    return gates


@pytest.mark.parametrize("key", list(common.CONFIGS))
def test_every_int8_layer_has_a_plan_and_the_gate_is_jaxs(key):
    model = quant.name_layers(common.port_model(key))
    admitted = common.int8_layers(model)
    for m in admitted:
        for dt in (torch.float32, torch.bfloat16):
            assert pick_bn_int8(m.out_ch, m.in_ch, m.ksize, False, dt), \
                (m.qpath, dt)
    gates = _jax_gates(key)
    assert {m.qpath for m in admitted} == {p for p, g in gates.items() if g}
    kept = {m.qpath for m in model.modules()
            if isinstance(m, common.ConvLayer) and not m._int8_eligible()}
    assert kept == {p for p, g in gates.items() if not g}
