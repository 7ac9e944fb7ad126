"""The port's multi-leg conv (CPU, plain version) against the JAX Pallas
kernel `conv_hiw_chain_multi(..., interpret=True)` on the six cases of
tests/test_hiw.py (dense concat, cross-batch b_offs, fuse_n legs, identity
leg, k1, 1-channel legs), at 1e-5 (f32 on both sides; the JAX kernel sums
banded products in another order). The JAX kernel reads H-major chain
tensors with guard bands; they are filled with garbage, as test_hiw.py
does, so the comparison covers the kernel's own reflect halo.

Also: ConvLayer's multi-leg route in serving (the plain version) and in
training (the concat, then F.conv2d, with gradients), and the helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu.ops.pallas.conv_kernel import (
    CHAIN_GUARD, CHAIN_WG, chain_shape)
from multi_modal_image_fusion_tpu.ops.pallas.hiw_kernel import (
    conv_hiw_chain_multi, hiw_enter, hiw_identity_weights)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_multi import (
    concat_legs, conv_multi, conv_multi_plain, identity_weights, legs_n_out)
from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer, \
    fast_training


def _to_hmajor(x, garbage=7.75):
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
    return np.asarray(jnp.transpose(sl, (0, 1, 3, 2)))


def _rand(r, *shape, lo=-0.5):
    return (r.rand(*shape) + lo).astype(np.float32)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w_hwio), (3, 2, 0, 1))))


def _case(name):
    """(legs as [(numpy NHWC, b_off)], HWIO weight, bias, fuse_n, n_out, h,
    w) of one test_hiw.py case."""
    r = np.random.RandomState(
        {"dense": 4, "cross": 5, "fuse": 6, "identity": 7, "k1": 8,
         "gray": 9}[name])
    bias, fuse_n = None, 0
    if name == "dense":
        h, w = 40, 96
        xs = [_rand(r, 2, h, w, 16), _rand(r, 2, h, w, 16),
              _rand(r, 2, h, w, 8)]
        wgt = _rand(r, 3, 3, 40, 16)
        bias = _rand(r, 16)
        legs, n_out = [(x, 0) for x in xs], 2
    elif name == "cross":
        h, w = 33, 61
        x = _rand(r, 4, h, w, 16)
        wgt = _rand(r, 3, 3, 32, 24)
        legs, n_out = [(x, 0), (x, 2)], 2
    elif name == "fuse":
        h, w = 32, 64
        xs = [_rand(r, 4, h, w, 16), _rand(r, 4, h, w, 16)]
        wgt = _rand(r, 3, 3, 32, 16)
        legs, n_out, fuse_n = [(x, 0) for x in xs], 2, 2
    elif name == "identity":
        h, w = 40, 96
        z, x = _rand(r, 2, h, w, 16), _rand(r, 2, h, w, 16)
        wgt = np.concatenate([_rand(r, 3, 3, 16, 16),
                              np.asarray(hiw_identity_weights(3, 16))], 2)
        legs, n_out = [(z, 0), (x, 0)], 2
    elif name == "k1":
        h, w = 24, 40
        xs = [_rand(r, 2, h, w, 16), _rand(r, 2, h, w, 16)]
        wgt = _rand(r, 1, 1, 32, 16)
        bias = _rand(r, 16)
        legs, n_out = [(x, 0) for x in xs], 2
    else:   # 1-channel legs with folded duplicate weights (PMGI entry)
        h, w = 40, 96
        i1, i2 = _rand(r, 2, h, w, 1, lo=0), _rand(r, 2, h, w, 1, lo=0)
        w3 = _rand(r, 5, 5, 3, 16)
        wgt = np.concatenate([w3[:, :, 0:1] + w3[:, :, 1:2], w3[:, :, 2:3]],
                             2)
        legs, n_out = [(i1, 0), (i2, 0)], 2
    return legs, wgt, bias, fuse_n, n_out, h, w


@pytest.mark.parametrize("name", ["dense", "cross", "fuse", "identity",
                                  "k1", "gray"])
def test_conv_multi_plain_vs_pallas(name):
    legs, wgt, bias, fuse_n, n_out, h, w = _case(name)
    c_out, k = wgt.shape[-1], wgt.shape[0]
    jlegs = tuple(hiw_enter(jnp.asarray(x)) if x.shape[-1] == 1
                  else _to_hmajor(jnp.asarray(x)) for x, _ in legs)
    want = conv_hiw_chain_multi(
        jlegs, jnp.asarray(wgt), k, h=h, w_valid=w,
        c_ins=tuple(x.shape[-1] for x, _ in legs),
        b_offs=tuple(off for _, off in legs), n_out=n_out,
        bias=None if bias is None else jnp.asarray(bias), act="relu",
        fuse_n=fuse_n, interpret=True)
    want = _from_hmajor(want, h, w, c_out)
    got = conv_multi([(torch.from_numpy(x), off) for x, off in legs],
                     _oihw(wgt),
                     None if bias is None else torch.from_numpy(bias),
                     "relu", fuse_n, n_out)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_identity_weights_match_jax():
    np.testing.assert_array_equal(
        identity_weights(3, 16).numpy(),
        _oihw(hiw_identity_weights(3, 16)).numpy())


def test_concat_legs_and_n_out():
    x = torch.arange(4 * 2 * 3 * 2, dtype=torch.float32).reshape(4, 2, 3, 2)
    y = x + 100
    assert legs_n_out([(x, 0), (y, 2)]) == 2
    assert legs_n_out([(x, 0), (y, 0)], fuse_n=2) == 2
    cat = concat_legs([(x, 0), (y, 2)])
    assert torch.equal(cat, torch.cat([x[:2], y[2:]], -1))
    cat = concat_legs([(x, 0), (y, 0)], fuse_n=2)
    assert torch.equal(cat, torch.cat([x, y], -1))


def test_conv_layer_legs_serving_and_training():
    """A ConvLayer on legs: serving runs the plain version (CPU tensors);
    under fast_training(False) it concatenates the legs and runs F.conv2d,
    with gradients reaching the legs and the weights; fuse_n sums the
    halves first."""
    r = np.random.RandomState(10)
    a = torch.from_numpy(_rand(r, 4, 12, 14, 16))
    b = torch.from_numpy(_rand(r, 4, 12, 14, 8))
    layer = ConvLayer(24, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.bias.uniform_(-0.1, 0.1)
    for fuse_n in (0, 2):
        legs = [(a, 0), (b, 0)]
        cat = torch.cat([a, b], -1)
        x = cat[:2] + cat[2:] if fuse_n else cat
        want = torch.relu(F.conv2d(
            F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
            layer.weight, layer.bias)).permute(0, 2, 3, 1)
        with torch.no_grad():
            served = layer(legs, fuse_n=fuse_n)
        np.testing.assert_allclose(served.numpy(), want.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        a_g = a.clone().requires_grad_()
        with fast_training(False):
            trained = layer([(a_g, 0), (b, 0)], fuse_n=fuse_n)
        np.testing.assert_allclose(trained.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        trained.sum().backward()
        assert float(a_g.grad.abs().sum()) > 0
        assert float(layer.weight.grad.abs().sum()) > 0
        layer.zero_grad()


def test_conv_multi_plain_keeps_dtype():
    r = np.random.RandomState(11)
    x = torch.from_numpy(_rand(r, 2, 9, 10, 16)).bfloat16()
    wt = torch.from_numpy(_rand(r, 16, 32, 3, 3))
    y = conv_multi_plain([(x, 0), (x, 0)], wt)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 9, 10, 16)


def test_plain_conv_in_batch_chunks(monkeypatch):
    """The plain conv splits the batch where a padded chunk would pass
    torch's 32-bit reflect-pad index; the chunks give the same result."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda import conv_chain as cc
    r = np.random.RandomState(12)
    x = torch.from_numpy(_rand(r, 3, 9, 10, 16))
    wt = torch.from_numpy(_rand(r, 16, 16, 3, 3))
    whole = cc.conv_chain_plain(x, wt, None, "relu")
    assert cc.batch_step(9, 10, 16, 3) >= 3
    assert cc.batch_step(1224, 1024, 128, 3) == 13
    monkeypatch.setattr(cc, "batch_step", lambda *a: 1)
    torch.testing.assert_close(cc.conv_chain_plain(x, wt, None, "relu"),
                               whole, rtol=0, atol=0)
