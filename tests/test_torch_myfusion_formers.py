"""MyFusion's MetaFormer, MixConv and transformer encoder blocks and the
new ConvLayer options in the port (plain path, CPU), against the JAX
package (harness: tests/test_torch_myfusion.py):

- MixConvBlock at MyFusion's widths 16 and 32, FFN,
  Attention ('stride' and 'avgpool' pools, sr 1 with its dead pool, qkv
  and proj bias), the four Former blocks in eval mode with seeded batch
  statistics and the base MetaFormer with layer norms and both scales,
  each against the JAX block's `apply` on the same seeded weights
  (utils/jax_convert.jax_block_to_state_dict), and against the reference
  goldens `tests/golden/block_*.npz`, state dicts loaded by their own
  names;
- ChannelLayerNorm, ConvLayer with hswish, silu and gelu (a dense k3
  conv, the 8-channel k1 enter of MyFusion's conv_in, a k1 depthwise
  conv) and with norm="layer", against the JAX layers;
- the attention's plain version against torch's SDPA (math backend, CPU),
  the standalone batch norm's refused training route.

Inputs from a numpy seed, 24x24 or smaller; tolerance 1e-4
(docs/PARITY.md, layers and model forwards).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_myfusion as mf
from conftest import nchw_to_nhwc, nhwc_to_nchw
from param_synth import synth_state_dict

from multi_modal_image_fusion_tpu.ops import blocks as jblocks
from multi_modal_image_fusion_tpu.ops import layers as jlayers
from multi_modal_image_fusion_tpu_torch.ops import blocks, layers
from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_block_to_state_dict

ATOL = 1e-4

# case: (JAX block, port block, carry kind, input shape)
BLOCKS = {
    "mix": (lambda: jblocks.MixConvBlock(32),
            lambda: blocks.MixConvBlock(32), "mix", (2, 24, 24, 32)),
    "mix16": (lambda: jblocks.MixConvBlock(16),
              lambda: blocks.MixConvBlock(16), "mix", (2, 24, 24, 16)),
    "ffn": (lambda: jblocks.FFN(), lambda: blocks.FFN(32), "ffn",
            (2, 24, 24, 32)),
    "attn32": (lambda: jblocks.Attention(32),
               lambda: blocks.Attention(32), "attention",
               (2, 24, 24, 32)),
    "attn32_avgpool": (lambda: jblocks.Attention(32, down_mode="avgpool"),
                       lambda: blocks.Attention(32, down_mode="avgpool"),
                       "attention", (2, 24, 24, 32)),
    "attn64_bias": (lambda: jblocks.Attention(64, qkv_bias=True,
                                              proj_bias=True),
                    lambda: blocks.Attention(64, qkv_bias=True,
                                             proj_bias=True),
                    "attention", (2, 16, 16, 64)),
    "attn256_sr1": (lambda: jblocks.Attention(256),
                    lambda: blocks.Attention(256), "attention",
                    (1, 8, 8, 256)),
    "conv_former": (lambda: jblocks.ConvFormerBlock(32),
                    lambda: blocks.ConvFormerBlock(32), "conv_former",
                    (2, 24, 24, 32)),
    "mix_former": (lambda: jblocks.MixFormerBlock(32),
                   lambda: blocks.MixFormerBlock(32), "mix_former",
                   (2, 24, 24, 32)),
    "res2_former": (lambda: jblocks.Res2FormerBlock(32),
                    lambda: blocks.Res2FormerBlock(32), "res2_former",
                    (2, 24, 24, 32)),
    "transformer": (lambda: jblocks.TransformerBlock(32),
                    lambda: blocks.TransformerBlock(32), "transformer",
                    (2, 24, 24, 32)),
    "metaformer_scales": (
        lambda: jblocks.MetaFormerBlock(32, layer_scale=0.5, res_scale=2.0),
        lambda: blocks.MetaFormerBlock(32, layer_scale=0.5, res_scale=2.0),
        "metaformer", (2, 24, 24, 32)),
}
# the reference goldens (tests/test_block_parity.py's cases)
GOLDENS = ("attn32", "attn32_avgpool", "attn64_bias", "attn256_sr1",
           "conv_former", "mix_former", "res2_former", "transformer",
           "metaformer_scales")


def _rand(seed, shape, lo=0.0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32) + lo


def _jax_vars(module, *inputs, seed=3):
    """A JAX module's params and batch statistics from mf.seeded_tree."""
    shapes = jax.eval_shape(functools.partial(module.init, train=False),
                            jax.random.PRNGKey(0), *inputs)
    shapes = {k: shapes[k] for k in ("params", "batch_stats") if k in shapes}
    return mf.seeded_tree(shapes, seed)


def _jax_apply(module, variables, *inputs):
    with jax.default_matmul_precision("float32"):
        return np.asarray(module.apply(variables, *map(jnp.asarray, inputs),
                                       train=False))


def _port(module, x):
    with torch.no_grad():
        return module.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_vs_jax(case):
    jctor, pctor, kind, shape = BLOCKS[case]
    x = _rand(20, shape)
    jblock, block = jctor(), pctor()
    v = _jax_vars(jblock, x)
    want = _jax_apply(jblock, v, x)
    sd = jax_block_to_state_dict(v, kind)
    assert sorted(sd) == sorted(block.state_dict())
    block.load_state_dict(sd)
    got = _port(block, x)
    assert want.std() > 1e-2
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("case", GOLDENS)
def test_block_vs_reference_golden(golden, case):
    """The reference block's output on its golden input, the port block's
    state dict loaded by the reference's names (its keys and shapes are
    the golden's)."""
    d = golden(f"block_{case}")
    keyshapes = json.loads(bytes(d["keyshapes"]).decode())
    block = BLOCKS[case][1]()
    assert {k: list(v.shape) for k, v in block.state_dict().items()} \
        == keyshapes
    block.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synth_state_dict(keyshapes).items()})
    got = _port(block, np.ascontiguousarray(nchw_to_nhwc(d["x"])))
    np.testing.assert_allclose(nhwc_to_nchw(got), d["y"], atol=ATOL)


def test_channel_layer_norm():
    x = _rand(21, (2, 24, 24, 32), lo=-0.5) * 3.0
    jnorm = jlayers.ChannelLayerNorm(32)
    v = _jax_vars(jnorm, x)
    want = np.asarray(jnorm.apply(v, jnp.asarray(x)))
    norm = layers.ChannelLayerNorm(32)
    norm.load_state_dict({"weight": torch.from_numpy(
        v["params"]["scale"].reshape(32, 1, 1))})
    np.testing.assert_allclose(_port(norm, x), want, atol=ATOL)


def _conv_layer_case(jlayer, layer, x, enter=False):
    v = _jax_vars(jlayer, x)
    want = _jax_apply(jlayer, v, x)
    p = v["params"]
    sd = {"layers.0.weight": torch.from_numpy(np.ascontiguousarray(
        np.transpose(p["kernel"], (3, 2, 0, 1))))}
    if "bias" in p:
        sd["layers.0.bias"] = torch.from_numpy(p["bias"])
    if "norm" in p:
        sd["layers.1.weight"] = torch.from_numpy(
            p["norm"]["scale"].reshape(-1, 1, 1))
    layer.load_state_dict(sd)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = (layer.eval().enter(xt) if enter else layer.eval()(xt)).numpy()
    assert want.std() > 1e-2
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("act", ["hswish", "silu", "gelu"])
@pytest.mark.parametrize("kind", ["dense_k3", "enter_k1", "depthwise_k1"])
def test_conv_layer_torch_acts(act, kind):
    """The activations no kernel fuses, after the kernel's plain version:
    a dense k3 conv (conv_chain), MyFusion's conv_in (the 8-channel k1
    enter), level 1's k1 depthwise down (conv_dw)."""
    if kind == "dense_k3":
        x = _rand(22, (2, 20, 24, 16), lo=-0.5)
        _conv_layer_case(jlayers.ConvLayer(16, ksize=3, act=act),
                         ConvLayer(16, 16, 3, act=act), x)
    elif kind == "enter_k1":
        x = _rand(23, (2, 20, 24, 1))
        _conv_layer_case(jlayers.ConvLayer(8, ksize=1, act=act),
                         ConvLayer(1, 8, 1, act=act), x, enter=True)
    else:
        x = _rand(24, (2, 20, 24, 8), lo=-0.5)
        _conv_layer_case(jlayers.ConvLayer(8, ksize=1, groups=8, padding=0,
                                           act=act, use_bias=False),
                         ConvLayer(8, 8, 1, act=act, groups=8, padding=0,
                                   use_bias=False), x)


@pytest.mark.parametrize("act", ["relu6", "gelu"])
@pytest.mark.parametrize("kind", ["dense_k3", "enter_k1"])
def test_conv_layer_layer_norm(act, kind):
    """norm="layer": the kernel without its activation, the channel layer
    norm, then the activation."""
    if kind == "dense_k3":
        x = _rand(25, (2, 20, 24, 16), lo=-0.5)
        _conv_layer_case(jlayers.ConvLayer(16, ksize=3, act=act, norm="layer"),
                         ConvLayer(16, 16, 3, act=act, norm="layer"), x)
    else:
        x = _rand(26, (2, 20, 24, 1))
        _conv_layer_case(jlayers.ConvLayer(8, ksize=1, act=act, norm="layer"),
                         ConvLayer(1, 8, 1, act=act, norm="layer"), x,
                         enter=True)


@pytest.mark.parametrize("heads", [1, 4])
def test_attention_plain_vs_sdpa(heads):
    """The plain attention against torch's SDPA on the CPU (its math
    backend) on the same head layout."""
    r = np.random.RandomState(27)
    q, k, v = (torch.from_numpy(r.randn(2, n, 16 * heads).astype(np.float32))
               for n in (96, 12, 12))
    got = blocks.attention_plain(q, k, v, heads)

    def split(t):
        return t.reshape(2, -1, heads, 16).transpose(1, 2)
    want = torch.nn.functional.scaled_dot_product_attention(
        split(q), split(k), split(v)).transpose(1, 2).reshape(2, 96, -1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_standalone_batch_norm_training_refused():
    """A MetaFormer's batch norm serves in eval mode only: a trainer scope
    or a gradient raises (ROADMAP queue 1 item 5)."""
    bn = layers.BatchNormNHWC(16)
    x = torch.rand(1, 8, 8, 16)
    with torch.no_grad():
        assert bn(x).shape == x.shape
        with layers.fast_training(False), pytest.raises(NotImplementedError):
            bn(x)
    with pytest.raises(NotImplementedError):
        bn(x)
