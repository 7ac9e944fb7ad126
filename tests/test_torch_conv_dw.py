"""The port's depthwise conv (ops/cuda/conv_dw.py plain version and
ConvLayer's depthwise routes, CPU) against the JAX package and F.conv2d.

- `conv_dw_plain` on a channel window of a wider tensor, with and without
  the added second tensor, against F.conv2d(groups=C) on the sliced and
  summed input: 1e-6 (the same f32 conv);
- `ConvLayer(groups=C)` (`depthwise` on a window, `forward` on a whole
  tensor) against the JAX `ConvLayer(groups=C)` with carried weights, with
  and without bias, at Res2Fusion's k1/k3 and widths: 2e-5 (docs/PARITY.md
  layer budget);
- the training route (F.conv2d(groups=C) when a gradient is needed) gives
  the serving route's values and a gradient, inside `fast_training(True)`
  too (the JAX package's gate sends a depthwise conv to XLA's conv there);
- `use_bias=False` leaves no bias key; only dense or depthwise groups are
  accepted; the wrapper's refusals on tensors that are not on the CPU
  (meta tensors: the checks run before any launch);
- the kernel's tap packing (`pack_taps`, called directly: CPU tensors take
  the plain version): [K*K][C] f32 taps and f32 bias, packed once and
  reused while the tensors keep their storage and version, packed anew
  after an in-place change, a checkpoint load or an optimizer step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu.ops.layers import ConvLayer as JConvLayer
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_dw import (
    conv_dw, conv_dw_plain, pack_taps)
from multi_modal_image_fusion_tpu_torch.ops.layers import (ConvLayer,
                                                           fast_training)


def _rand(r, *shape):
    return torch.from_numpy((r.rand(*shape) * 2 - 0.5).astype(np.float32))


@pytest.mark.parametrize("cx,c,k,lo,with_add", [
    (64, 16, 1, 0, False), (64, 16, 3, 16, False), (64, 16, 3, 48, True),
    (384, 48, 3, 336, True), (24, 8, 3, 8, True)])
def test_plain_vs_conv2d(cx, c, k, lo, with_add):
    r = np.random.RandomState(cx + lo)
    x = _rand(r, 2, 13, 17, cx)
    wt = _rand(r, c, 1, k, k)
    bias = _rand(r, c)
    add = _rand(r, 2, 13, 17, c) if with_add else None
    xin = x[..., lo:lo + c] + (0 if add is None else add)
    p = k // 2
    xp = F.pad(xin.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    want = torch.relu(F.conv2d(xp, wt, bias, groups=c)).permute(0, 2, 3, 1)
    for got in (conv_dw_plain(x, wt, bias, "relu", lo, add),
                conv_dw(x, wt, bias, "relu", lo, add)):
        assert got.shape == (2, 13, 17, c) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def _jax_dw(c, k, use_bias, x, seed):
    jl = JConvLayer(c, ksize=k, groups=c, act=None, use_bias=use_bias)
    p = dict(jl.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    if use_bias:
        p["bias"] = jnp.asarray(np.random.RandomState(seed).rand(c) - 0.5,
                                jnp.float32)
    with jax.default_matmul_precision("float32"):
        want = jl.apply({"params": p}, jnp.asarray(x))
    sd = {"layers.0.weight": torch.from_numpy(np.array(
        np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))))}
    if use_bias:
        sd["layers.0.bias"] = torch.from_numpy(np.array(p["bias"]))
    return np.asarray(want), sd


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("c,k", [(16, 1), (16, 3), (48, 3)])
def test_conv_layer_depthwise_vs_jax(c, k, use_bias):
    r = np.random.RandomState(c + k)
    x = _rand(r, 2, 19, 23, 4 * c)
    add = _rand(r, 2, 19, 23, c)
    lo = 2 * c
    want, sd = _jax_dw(c, k, use_bias, (x[..., lo:lo + c] + add).numpy(),
                       c + k)
    layer = ConvLayer(c, c, ksize=k, act=None, groups=c, use_bias=use_bias)
    layer.load_state_dict(sd)
    with torch.no_grad():
        got = layer.depthwise(x, lo=lo, add=add)
        whole = layer(x[..., lo:lo + c].contiguous() + add)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(whole.numpy(), want, rtol=2e-5, atol=2e-5)


def test_training_route_matches_serving():
    r = np.random.RandomState(3)
    x = _rand(r, 2, 11, 14, 32)
    add = _rand(r, 2, 11, 14, 16)
    layer = ConvLayer(16, 16, ksize=3, act=None, groups=16, use_bias=False)
    with torch.no_grad():
        want = layer.depthwise(x, lo=16, add=add)
    got = layer.depthwise(x, lo=16, add=add)          # weight needs grad
    assert got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-6)
    got.sum().backward()
    assert float(layer.weight.grad.abs().sum()) > 0
    with fast_training(False), torch.no_grad():
        np.testing.assert_allclose(
            layer.depthwise(x, lo=16, add=add).numpy(), want.numpy(),
            atol=1e-6)
    # fast training: the JAX package trains a depthwise conv on XLA's conv
    # there too, so the layer takes F.conv2d(groups) and keeps its gradient
    with fast_training(True):
        got = layer.depthwise(x, lo=16, add=add)
    assert got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-6)


def test_conv_layer_bias_and_groups():
    layer = ConvLayer(8, 16, ksize=1, act=None, use_bias=False)
    assert sorted(layer.state_dict()) == ["layers.0.weight"]
    assert layer.bias is None
    dw = ConvLayer(48, 48, ksize=3, groups=48, use_bias=False)
    assert tuple(dw.weight.shape) == (48, 1, 3, 3)
    with pytest.raises(ValueError):
        ConvLayer(16, 32, ksize=3, groups=16)
    with pytest.raises(ValueError):
        ConvLayer(16, 16, ksize=3, groups=4)
    x = torch.rand(1, 6, 7, 8)
    with torch.no_grad():
        y = layer(x)
        want = F.conv2d(x.permute(0, 3, 1, 2), layer.weight)
    np.testing.assert_allclose(y.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               atol=1e-6)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,err", [
    ("k5", ValueError), ("width", ValueError), ("window", ValueError),
    ("add", ValueError), ("half", TypeError), ("not_cuda", ValueError),
    ("grad", RuntimeError)])
def test_wrapper_refuses(case, err):
    x, wt, lo, add = _meta(2, 9, 9, 64), _meta(16, 1, 3, 3), 16, None
    if case == "k5":
        wt = _meta(16, 1, 5, 5)
    elif case == "width":
        wt = _meta(12, 1, 3, 3)
    elif case == "window":
        lo = 56
    elif case == "add":
        add = _meta(2, 9, 9, 32)
    elif case == "half":
        x = x.half()
    elif case == "grad":
        wt.requires_grad_()
    with pytest.raises(err):
        conv_dw(x, wt, None, None, lo, add)


@pytest.mark.parametrize("k,use_bias", [(1, False), (3, False), (3, True)])
def test_pack_taps_layout(k, use_bias):
    r = np.random.RandomState(k)
    wt = _rand(r, 48, 1, k, k).to(torch.bfloat16)
    bias = _rand(r, 48).to(torch.bfloat16) if use_bias else None
    wk, bk = pack_taps(wt, bias)
    assert wk.dtype == torch.float32 and wk.shape == (k * k, 48)
    assert wk.is_contiguous()
    for dy in range(k):
        for dx in range(k):
            np.testing.assert_array_equal(
                wk[dy * k + dx].numpy(), wt[:, 0, dy, dx].float().numpy())
    if use_bias:
        assert bk.dtype == torch.float32
        np.testing.assert_array_equal(bk.numpy(), bias.float().numpy())
    else:
        assert bk is None


def test_pack_taps_cache():
    """Packed once a layer; packed anew after the weight or bias changes in
    place, after a load_state_dict and after an optimizer step; a tensor of
    equal values is packed on its own."""
    r = np.random.RandomState(5)
    wt, bias = _rand(r, 16, 1, 3, 3), _rand(r, 16)
    wk, bk = pack_taps(wt, bias)
    again = pack_taps(wt, bias)
    assert again[0] is wk and again[1] is bk
    with torch.no_grad():
        wt.mul_(2.0)
    wk2, _ = pack_taps(wt, bias)
    assert wk2 is not wk
    np.testing.assert_array_equal(wk2.numpy(),
                                  wt.reshape(16, 9).t().numpy())
    with torch.no_grad():
        bias.add_(1.0)
    _, bk2 = pack_taps(wt, bias)
    np.testing.assert_array_equal(bk2.numpy(), bias.numpy())
    twin = wt.clone()
    assert pack_taps(twin)[0] is not pack_taps(wt)[0]

    layer = ConvLayer(16, 16, ksize=3, act=None, groups=16, use_bias=False)
    first = pack_taps(layer.weight)[0]
    assert pack_taps(layer.weight)[0] is first
    layer.load_state_dict({"layers.0.weight": 0.5 * layer.weight.detach()})
    loaded = pack_taps(layer.weight)[0]
    assert loaded is not first
    np.testing.assert_allclose(loaded.numpy(), 0.5 * first.numpy())
    opt = torch.optim.SGD(layer.parameters(), lr=0.1)
    layer.weight.grad = torch.ones_like(layer.weight)
    opt.step()
    stepped = pack_taps(layer.weight)[0]
    np.testing.assert_allclose(stepped.numpy(), loaded.numpy() - 0.1,
                               atol=1e-7)
