"""The port's conv layers (plain versions, CPU) against the JAX package.

- `conv_chain_plain` against `conv_hiw_chain` (Pallas, interpret mode) at
  tests/test_hiw.py's shapes, with the fuse_n siamese sum, and the c_in=1 /
  c_out=1 enter/exit layers against `hiw_enter`/`hiw_exit` around it:
  atol = rtol = 1e-5 (same f32 conv, another summation order).
- `ConvLayer` against the JAX `ConvLayer` with carried weights: 2e-5
  (docs/PARITY.md layer budget).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.ops.layers import ConvLayer as JConvLayer
from multi_modal_image_fusion_tpu.ops.pallas.conv_kernel import (
    CHAIN_GUARD, CHAIN_WG, chain_shape)
from multi_modal_image_fusion_tpu.ops.pallas.hiw_kernel import (
    conv_hiw_chain, hiw_enter, hiw_exit)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    conv_chain, conv_chain_plain, conv_gray_enter, conv_gray_exit)
from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer


def _to_hmajor(x, garbage=7.75):
    """NHWC -> (B, HG*C, Wp) with garbage guard bands (copy of
    tests/test_hiw.py's helper)."""
    b, h, w, c = x.shape
    hg, wp = chain_shape(h, w)
    t = jnp.full((b, hg, c, wp), garbage, x.dtype)
    t = jax.lax.dynamic_update_slice(
        t, jnp.transpose(x, (0, 1, 3, 2)), (0, CHAIN_GUARD, 0, CHAIN_WG))
    return t.reshape(b, hg * c, wp)


def _from_hmajor(t, h, w, c):
    b, hgc, wp = t.shape
    t = t.reshape(b, hgc // c, c, wp)
    sl = t[:, CHAIN_GUARD:CHAIN_GUARD + h, :, CHAIN_WG:CHAIN_WG + w]
    return jnp.transpose(sl, (0, 1, 3, 2))


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w_hwio), (3, 2, 0, 1))))


@pytest.mark.parametrize("k,c_in,c_out,h,w", [
    (7, 32, 32, 40, 130),    # dec0 shape class
    (5, 16, 32, 45, 61),     # odd h and w
    (7, 16, 32, 33, 96),     # h far from a rows multiple
    (5, 32, 16, 48, 128),
    (5, 16, 8, 24, 40),      # c_out < 16
])
def test_conv_chain_plain_vs_hiw(k, c_in, c_out, h, w):
    r = np.random.RandomState(0)
    x = (r.rand(2, h, w, c_in) - 0.5).astype(np.float32)
    wgt = (r.rand(k, k, c_in, c_out) - 0.5).astype(np.float32)
    bias = (r.rand(c_out) - 0.5).astype(np.float32)
    want = _from_hmajor(conv_hiw_chain(
        _to_hmajor(jnp.asarray(x)), jnp.asarray(wgt), k, h=h, w_valid=w,
        c_in=c_in, bias=jnp.asarray(bias), act="relu", interpret=True),
        h, w, c_out)
    got = conv_chain(torch.from_numpy(x), _oihw(wgt),
                     torch.from_numpy(bias), "relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_conv_chain_plain_fused_siamese_sum():
    r = np.random.RandomState(2)
    h, w = 32, 64
    x = (r.rand(4, h, w, 16) - 0.5).astype(np.float32)
    wgt = (r.rand(7, 7, 16, 16) - 0.5).astype(np.float32)
    want = _from_hmajor(conv_hiw_chain(
        _to_hmajor(jnp.asarray(x)), jnp.asarray(wgt), 7, h=h, w_valid=w,
        c_in=16, act="relu", fuse_n=2, interpret=True), h, w, 16)
    got = conv_chain_plain(torch.from_numpy(x), _oihw(wgt), None, "relu",
                           fuse_n=2)
    assert got.shape == (2, h, w, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gray_enter_and_exit_plain_vs_hiw():
    """c_in=1 entry (hiw_enter + the 1->16 conv) and c_out=1 exit (the
    16->1 conv + hiw_exit), each on the same input as the JAX kernels."""
    r = np.random.RandomState(1)
    h, w = 40, 96
    img1 = r.rand(2, h, w, 1).astype(np.float32)
    img2 = r.rand(2, h, w, 1).astype(np.float32)
    w0 = (r.rand(5, 5, 1, 16) - 0.5).astype(np.float32)
    b0 = (r.rand(16) - 0.5).astype(np.float32)
    t = conv_hiw_chain(hiw_enter(jnp.asarray(np.concatenate([img1, img2]))),
                       jnp.asarray(w0), 5, h=h, w_valid=w, c_in=1,
                       bias=jnp.asarray(b0), act="relu", interpret=True)
    feat = conv_gray_enter(torch.from_numpy(img1), torch.from_numpy(img2),
                           _oihw(w0), torch.from_numpy(b0), "relu")
    np.testing.assert_allclose(feat.numpy(),
                               np.asarray(_from_hmajor(t, h, w, 16)),
                               rtol=1e-5, atol=1e-5)

    w2 = (r.rand(5, 5, 16, 1) - 0.5).astype(np.float32)
    b2 = (r.rand(1) - 0.5).astype(np.float32)
    y = hiw_exit(conv_hiw_chain(t, jnp.asarray(w2), 5, h=h, w_valid=w,
                                c_in=16, bias=jnp.asarray(b2),
                                interpret=True), h, w)
    got = conv_gray_exit(feat, _oihw(w2), torch.from_numpy(b2), None)
    assert got.shape == (4, h, w, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act", ["relu", "relu6", "lrelu", "tanh", None])
@pytest.mark.parametrize("k,c_in,c_out", [(3, 8, 16), (5, 1, 16),
                                          (7, 16, 32), (5, 16, 1)])
def test_conv_layer_vs_jax(act, k, c_in, c_out):
    r = np.random.RandomState(k * 100 + c_in + c_out)
    x = r.rand(2, 19, 23, c_in).astype(np.float32) * 2.0 - 0.5
    jl = JConvLayer(c_out, ksize=k, act=act)
    variables = jl.init(jax.random.PRNGKey(k + c_out), jnp.asarray(x))
    p = variables["params"]
    bias = (r.rand(c_out) - 0.5).astype(np.float32)   # init bias is zero
    p = {"kernel": p["kernel"], "bias": jnp.asarray(bias)}
    with jax.default_matmul_precision("float32"):
        want = jl.apply({"params": p}, jnp.asarray(x))
    layer = ConvLayer(c_in, c_out, ksize=k, act=act)
    layer.load_state_dict({"layers.0.weight": _oihw(p["kernel"]),
                           "layers.0.bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_conv_layer_rejects_unported():
    with pytest.raises(ValueError):
        ConvLayer(4, 8, act="gelu")
    with pytest.raises(ValueError):
        ConvLayer(4, 8, ksize=4)


@pytest.mark.parametrize("fast", [False, True])
def test_train_conv_pads_in_batch_chunks(monkeypatch, fast):
    """The training routes pad and convolve in batch chunks of
    `batch_step` images (torch's reflect pad refuses 2^31 elements; the
    card test `test_train_conv_reflect_pad_past_int32` hits it): with a
    step of 2 images the output and the gradients equal one whole-batch
    call's."""
    from multi_modal_image_fusion_tpu_torch.ops import layers
    from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training
    layer = ConvLayer(8, 16, ksize=5,
                      generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).rand(5, 9, 11, 8).astype(
        np.float32))

    def run():
        layer.zero_grad()
        xg = x.clone().requires_grad_()
        with fast_training(fast):
            y = layer(xg)
        (y * y).sum().backward()
        return y.detach(), xg.grad, layer.weight.grad.clone()
    want = run()
    calls = []
    monkeypatch.setattr(layers, "batch_step",
                        lambda *a: calls.append(a) or 2)
    got = run()
    assert calls and calls[0] == (9, 11, 16, 5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
