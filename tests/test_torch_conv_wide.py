"""The port's wide chain conv (CPU, plain version) against the JAX Pallas
kernel `conv_tlane_chain(..., halo=True, interpret=True)`.

The JAX side runs as the JAX package's ConvLayer chain route does
(ops/layers.py:579-591): each leg enters the C-major guard layout
(`chain_enter`), the kernel convolves each part without bias or activation,
the parts are summed, then the bias and the activation are applied once;
`chain_exit` leaves the layout. Cases: two parts, c_in 40 and 56, c_out 8,
40 and 56, k1 and k3, fuse_n, every fused activation. Tolerance 1e-5
(f32 on both sides; the kernel sums its products in another order).

Also: the int8 body's output-channel block at UNFusion's decoder layers
(`pick_bn_int8`; its plans: tests/test_torch_conv_int8.py), ConvLayer's wide
route in serving and in training, and the plain version's batch chunks. The
bf16 kernel's weight packing, block and staged source index are conv_chain's
(tests/test_torch_conv_chain_tc.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu.ops.layers import get_act
from multi_modal_image_fusion_tpu.ops.pallas.conv_kernel import (
    chain_enter, chain_exit, conv_tlane_chain)
from multi_modal_image_fusion_tpu_torch.ops.cuda import conv_wide as cw
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import \
    pick_bn_int8
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_multi import concat_legs
from multi_modal_image_fusion_tpu_torch.ops import layers
from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer, \
    fast_training

H, W = 13, 20
# (c_in of each leg, c_out, k, act, fuse_n)
CASES = {
    "two_parts_k3": ([40, 56], 40, 3, "relu", 0),
    "cout8_fuse": ([56], 8, 3, None, 2),
    "k1_two_parts": ([40, 56], 56, 1, "lrelu", 0),
    "k3_tanh": ([16, 24], 56, 3, "tanh", 0),
    "fuse_two_parts": ([40, 16], 40, 3, "relu6", 1),
}


def _case(name):
    cins, cout, k, act, fuse_n = CASES[name]
    r = np.random.RandomState(sorted(CASES).index(name))
    b = 2 * fuse_n if fuse_n else 2
    xs = [(r.rand(b, H, W, c) - 0.5).astype(np.float32) for c in cins]
    wt = ((r.rand(k, k, sum(cins), cout) - 0.5)
          / np.sqrt(sum(cins) * k * k)).astype(np.float32)
    bias = (0.2 * (r.rand(cout) - 0.5)).astype(np.float32)
    return xs, wt, bias, k, act, fuse_n


def _jax_chain(xs, wt, bias, k, act, fuse_n):
    y, ofs = None, 0
    for x in xs:
        c = x.shape[-1]
        yi = conv_tlane_chain(chain_enter(jnp.asarray(x)),
                              jnp.asarray(wt[:, :, ofs:ofs + c]), k, h=H,
                              w_valid=W, halo=True, fuse_n=fuse_n,
                              interpret=True)
        y = yi if y is None else y + yi
        ofs += c
    y = get_act(act)(y + jnp.asarray(bias)[None, :, None, None])
    return np.asarray(chain_exit(y, H, W))


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_vs_jax_chain_kernel(name):
    xs, wt, bias, k, act, fuse_n = _case(name)
    want = _jax_chain(xs, wt, bias, k, act, fuse_n)
    legs = [(torch.from_numpy(x), 0) for x in xs]
    got = cw.conv_wide(legs, _oihw(wt), torch.from_numpy(bias), act, fuse_n)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("cins,cout,k,bn", [
    ([16, 64], 40, 3, 48), ([40], 16, 3, 16), ([64, 256], 160, 3, 32),
    ([160], 64, 3, 64), ([256, 1024], 640, 3, 128), ([640], 256, 3, 128),
    ([16, 16, 64], 48, 3, 48), ([64, 64, 256], 192, 3, 48),
    ([16, 16, 16, 64], 56, 3, 64), ([16], 1, 1, 16)])
def test_pick_bn(cins, cout, k, bn):
    """The int8 body's block (conv_int8.pick_bn_int8) at UNFusion's decoder
    layers under --int8 (bf16), on their legs' quantized concat."""
    assert pick_bn_int8(cout, sum(cins), k) == bn


def test_plain_in_batch_chunks(monkeypatch):
    """Chunked concat and conv equal one chunk, fuse_n and offsets too."""
    r = np.random.RandomState(1)
    a = torch.from_numpy(r.rand(6, 9, 11, 8).astype(np.float32))
    b = torch.from_numpy(r.rand(7, 9, 11, 16).astype(np.float32))
    wt = torch.from_numpy(r.rand(8, 24, 3, 3).astype(np.float32) - 0.5)
    legs = [(a, 0), (b, 1)]
    whole = cw.conv_wide_plain(legs, wt, None, "relu", fuse_n=3)
    monkeypatch.setattr(cw, "_PLAIN_CHUNK", 11 * 13 * 24)   # one image
    chunked = cw.conv_wide_plain(legs, wt, None, "relu", fuse_n=3)
    assert chunked.shape == (3, 9, 11, 8)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)


def test_plain_fuse_sum_in_the_legs_dtype():
    """bf16 legs: the siamese sum is rounded to bf16 before the conv, as a
    bf16 add (and the kernel's load) rounds it."""
    r = np.random.RandomState(2)
    x = torch.from_numpy(r.rand(2, 6, 7, 16).astype(np.float32)).bfloat16()
    wt = torch.from_numpy(r.rand(8, 16, 3, 3).astype(np.float32) - 0.5)
    got = cw.conv_wide_plain([(x, 0)], wt, None, None, fuse_n=1)
    want = cw.conv_wide_plain([((x[:1] + x[1:]), 0)], wt, None, None)
    assert torch.equal(got, want)


def test_layer_wide_routes():
    """ConvLayer(wide=True): serving over legs (the plain version on the
    CPU), training (concat, F.conv2d) with gradients reaching the weight."""
    torch.manual_seed(0)
    layer = ConvLayer(40, 24, 3, wide=True,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.bias.uniform_(-0.1, 0.1)
    a, b = torch.rand(2, 10, 12, 16), torch.rand(2, 10, 12, 24)
    legs = [(a, 0), (b, 0)]
    want = cw.conv_wide_plain(legs, layer.weight, layer.bias, "relu")
    with torch.no_grad():
        np.testing.assert_allclose(layer(legs).numpy(), want.detach().numpy(),
                                   atol=1e-6)
    x = torch.cat([a, b], -1)
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    ref = torch.relu(F.conv2d(xp, layer.weight, layer.bias)).permute(
        0, 2, 3, 1)
    with fast_training(False):
        y = layer(legs)
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(),
                               atol=1e-5)
    y.sum().backward()
    assert layer.weight.grad is not None and layer.weight.grad.abs().sum() > 0
    assert torch.equal(concat_legs(legs), x)


def test_layer_stride2_matches_reflect_conv():
    """A stride-2 layer: reflect pad k // 2, F.conv2d(stride=2), at odd
    sizes (ceil(H / 2) output rows)."""
    layer = ConvLayer(8, 16, 3, stride=2,
                      generator=torch.Generator().manual_seed(1))
    x = torch.rand(2, 23, 29, 8)
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    with torch.no_grad():
        y = layer(x)
        want = torch.relu(F.conv2d(xp, layer.weight, layer.bias, stride=2))
    assert y.shape == (2, 12, 15, 16)
    np.testing.assert_allclose(y.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("kw", [dict(stride=3), dict(stride=2, wide=True)])
def test_layer_refuses_unported_strides(kw):
    with pytest.raises(ValueError):
        ConvLayer(8, 8, 3, **kw)


def test_bilinear_upsample_in_batch_chunks(monkeypatch):
    """interpolate's bilinear path in batch chunks (torch's NHWC kernel
    takes outputs under 2^31 elements) equals one call."""
    x = torch.rand(5, 6, 7, 3)
    want = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=8,
                         mode="bilinear", align_corners=True)
    monkeypatch.setattr(layers, "INT32_ELEMS", 2 * 48 * 56 * 3)
    got = layers.interpolate(x, 8, "bilinear")
    assert got.is_contiguous()
    assert torch.equal(got, want.permute(0, 2, 3, 1))
