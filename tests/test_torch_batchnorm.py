"""ConvLayer's batch norm and the layers the five models of PFNetv1,
PFNetv2, IFCNN, DIFNet and PMGI add, on the CPU (plain versions):

- the fold (`ConvLayer.folded`) on every serving route a layer takes (one
  tensor, the gray enter and exit, legs, conv_wide, stride 2, depthwise)
  against conv -> F.batch_norm(training=False) -> activation on F.conv2d,
  with seeded non-trivial norms, and against the JAX layer's eager route;
- the training routes of a normed layer: the running statistics in eval
  mode, the batch statistics and flax's running update in train mode
  (against JAX: tests/test_torch_bn_train.py); its int8 route raises
  NotImplementedError, a norm not ported ValueError (the group norm is
  SEDRFuse's, tests/test_torch_sedrfuse.py);
- ResBlock against the JAX block;
- PFNetv2's block-diagonal fuse net against the channels-into-batch fold
  and the JAX fusion;
- the plain versions of the two-gray-leg enter and of the exit over legs
  against F.conv2d on the concatenated input, and the two-leg packing.

Tolerance 2e-5 (the docs/PARITY.md layer budget), f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu.ops.blocks import ResBlock as JResBlock
from multi_modal_image_fusion_tpu.ops.layers import ConvLayer as JConvLayer
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import layers, quant
from multi_modal_image_fusion_tpu_torch.ops.blocks import ResBlock
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    apply_act, conv_gray_enter, conv_gray_enter_plain, conv_gray_exit,
    conv_gray_exit_plain, pack_gray_enter)
from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer
from test_torch_zoo_common import random_norms

ATOL = 2e-5


def _x(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).rand(*shape)
                            .astype(np.float32) - 0.5)


def _reference(layer, x):
    """conv (reflect pad, F.conv2d, stride and groups of the layer) ->
    F.batch_norm(training=False) -> activation, NCHW inside."""
    p = layer.ksize // 2
    xn = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    y = F.conv2d(xn, layer.weight, layer.bias, stride=layer.stride,
                 groups=layer.groups)
    bn = layer.layers[1]
    y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     training=False, eps=1e-5)
    return apply_act(y, layer.act).permute(0, 2, 3, 1)


def _normed(cin, cout, k=3, act="relu", seed=0, **kw):
    layer = ConvLayer(cin, cout, k, act=act, norm="batch",
                      generator=torch.Generator().manual_seed(seed), **kw)
    with torch.no_grad():
        layer.bias.uniform_(-0.1, 0.1, generator=torch.Generator()
                            .manual_seed(seed + 1))
    return random_norms(layer, seed + 2).eval()


ROUTES = {
    # name: (c_in, c_out, k, act, layer kwargs)
    "chain": (16, 32, 3, "relu", {}),
    "chain_k5_lrelu": (16, 16, 5, "lrelu", {}),
    "enter": (1, 16, 7, None, {}),
    "exit": (16, 1, 1, "tanh", {}),
    "wide": (24, 8, 3, "relu", {"wide": True}),
    "stride2": (16, 16, 3, "relu", {"stride": 2}),
    "depthwise": (16, 16, 3, None, {"groups": 16}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fold_matches_conv_then_batch_norm(route):
    cin, cout, k, act, kw = ROUTES[route]
    layer = _normed(cin, cout, k, act, seed=3, **kw)
    x = _x((2, 13, 17, cin), 4)
    with torch.no_grad():
        got = layer.enter(x) if route == "enter" else layer(x)
        want = _reference(layer, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    # a fold left out would not pass
    with torch.no_grad():
        bare = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (k // 2,) * 4,
                              mode="reflect"), layer.weight, layer.bias,
                        stride=layer.stride, groups=layer.groups)
    assert float((apply_act(bare, act).permute(0, 2, 3, 1) - want)
                 .abs().max()) > 100 * ATOL


def test_fold_over_legs_and_pairs():
    """A normed layer over legs (conv_multi; the exit over legs) and with
    fuse_n, against the reference on the concat (or the sum)."""
    layer = _normed(32, 16, 3, "relu", seed=5)
    a, b = _x((2, 11, 14, 16), 6), _x((4, 11, 14, 16), 7)
    with torch.no_grad():
        got = layer([(a, 0), (b, 2)])
        want = _reference(layer, torch.cat([a, b[2:]], -1))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
        pair = torch.cat([a, b[:2]], 0)
        got = _normed(16, 16, 3, "relu", seed=8)(pair, fuse_n=2)
        ref = _normed(16, 16, 3, "relu", seed=8)
        want = _reference(ref, pair[:2] + pair[2:])
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
        head = _normed(32, 1, 1, "tanh", seed=9)
        got = head([(a, 0), (b, 1)])
        want = _reference(head, torch.cat([a, b[1:3]], -1))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_folded_accessor():
    """folded(): f32 fold cast to the asked dtype; without a norm the
    layer's own parameters."""
    layer = _normed(8, 16, seed=10)
    bn = layer.layers[1]
    g = bn.weight / torch.sqrt(bn.running_var + 1e-5)
    w, b = layer.folded()
    np.testing.assert_allclose(w.detach().numpy(), (layer.weight * g[:, None,
                               None, None]).detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        b.detach().numpy(),
        ((layer.bias - bn.running_mean) * g + bn.bias).detach().numpy(),
        rtol=1e-6, atol=1e-7)
    assert layer.folded(torch.bfloat16)[0].dtype == torch.bfloat16
    plain = ConvLayer(8, 16)
    assert plain.folded()[0] is plain.weight
    assert plain.folded()[1] is plain.bias


def test_state_dict_names():
    layer = ConvLayer(8, 16, norm="batch")
    assert sorted(layer.state_dict()) == [
        "layers.0.bias", "layers.0.weight", "layers.1.bias",
        "layers.1.num_batches_tracked", "layers.1.running_mean",
        "layers.1.running_var", "layers.1.weight"]
    bn = layer.layers[1]
    assert bn.eps == 1e-5 and bn.momentum == 0.1
    assert layer.bias is not None       # the conv keeps its bias


@pytest.mark.parametrize("act", ["relu", None])
def test_layer_vs_jax_eager(act):
    """The normed layer against the JAX ConvLayer's eager route
    (norm='batch', train=False), weights and statistics carried."""
    x = _x((2, 12, 15, 8), 11).numpy()
    jl = JConvLayer(16, norm="batch", act=act)
    v = jl.init(jax.random.PRNGKey(2), jnp.asarray(x))
    r = np.random.RandomState(12)
    p = jax.tree.map(np.array, v["params"])
    p["bias"] = r.uniform(-0.1, 0.1, 16).astype(np.float32)
    p["norm"] = {"scale": r.uniform(0.5, 1.5, 16).astype(np.float32),
                 "bias": r.uniform(-0.1, 0.1, 16).astype(np.float32)}
    st = {"norm": {"mean": r.uniform(-0.1, 0.1, 16).astype(np.float32),
                   "var": r.uniform(0.5, 2.0, 16).astype(np.float32)}}
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jl.apply({"params": p, "batch_stats": st},
                                   jnp.asarray(x)))
    layer = ConvLayer(8, 16, act=act, norm="batch")
    layer.load_state_dict({
        "layers.0.weight": torch.from_numpy(np.ascontiguousarray(
            p["kernel"].transpose(3, 2, 0, 1))),
        "layers.0.bias": torch.from_numpy(p["bias"]),
        "layers.1.weight": torch.from_numpy(p["norm"]["scale"]),
        "layers.1.bias": torch.from_numpy(p["norm"]["bias"]),
        "layers.1.running_mean": torch.from_numpy(st["norm"]["mean"]),
        "layers.1.running_var": torch.from_numpy(st["norm"]["var"]),
        "layers.1.num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = layer.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_training_routes_raise():
    """What the training routes of a normed layer do (they once raised):
    in eval mode, inside either `fast_training` scope and with a gradient,
    the conv, then the norm on the running statistics (the serving fold's
    function), and nothing moves; in train mode, the batch statistics
    (biased variance), the running statistics moved by flax's update and
    num_batches_tracked counting each call; serving folds in either mode
    and moves nothing."""
    layer = _normed(8, 16, seed=13)
    x = _x((2, 9, 9, 8), 14)
    with torch.no_grad():
        want = layer(x)                 # serving folds
    stats = [t.clone() for t in layer.layers[1].buffers()]
    for enable in (True, False):
        with layers.fast_training(enable), torch.no_grad():
            np.testing.assert_allclose(layer(x).numpy(), want.numpy(),
                                       atol=ATOL)
    got = layer(x)                      # a gradient is needed
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=ATOL)
    assert all(torch.equal(a, b)
               for a, b in zip(layer.layers[1].buffers(), stats))
    bn = layer.layers[1]
    layer.train()
    with torch.no_grad():
        assert torch.equal(layer(x), want)   # serving folds in train mode
    p = layer.ksize // 2
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (p,) * 4, mode="reflect"),
                 layer.weight, layer.bias)
    var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
    norm = (y - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + 1e-5)
    want_train = torch.relu(norm * bn.weight[:, None, None]
                            + bn.bias[:, None, None]).permute(0, 2, 3, 1)
    r_mean, r_var = stats[0].clone(), stats[1].clone()
    for calls, enable in enumerate((True, False, None), start=1):
        scope = (layers.fast_training(enable) if enable is not None
                 else torch.enable_grad())
        with scope:
            got = layer(x)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want_train.detach().numpy(), atol=ATOL)
        r_mean = 0.9 * r_mean + 0.1 * mean.detach()
        r_var = 0.9 * r_var + 0.1 * var.detach()
        torch.testing.assert_close(bn.running_mean, r_mean, atol=1e-6,
                                   rtol=1e-6)
        torch.testing.assert_close(bn.running_var, r_var, atol=1e-6,
                                   rtol=1e-6)
        assert int(bn.num_batches_tracked) == calls


def test_int8_route_raises():
    layer = _normed(8, 16, seed=15)
    layer.qpath = "conv"
    x = _x((1, 9, 9, 8), 16)
    with torch.no_grad(), quant.quantized_inference({}):
        with pytest.raises(NotImplementedError, match="int8"):
            layer(x)
    model = create_model("ifcnn")
    with torch.no_grad(), quant.quantized_inference({}):
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            model(_x((1, 16, 16, 1), 17) + 0.5)


@pytest.mark.parametrize("norm", ["none", "spectral", "instance"])
def test_other_norms_raise(norm):
    with pytest.raises(ValueError, match="batch"):
        ConvLayer(8, 16, norm=norm)


def test_resblock_vs_jax():
    """ResBlock(16, norm1='batch') against the JAX block's eager route
    (train=False), weights and statistics carried by name."""
    x = _x((2, 11, 13, 16), 18).numpy()
    jb = JResBlock(16, norm1="batch")
    v = jb.init(jax.random.PRNGKey(3), jnp.asarray(x))
    p = jax.tree.map(np.array, v["params"])
    st = jax.tree.map(np.array, v["batch_stats"])
    r = np.random.RandomState(19)
    block = ResBlock(16, norm1="batch")
    sd = {}
    for i in range(2):
        leaf = p[f"ConvLayer_{i}"]
        leaf["bias"] = r.uniform(-0.1, 0.1, 16).astype(np.float32)
        sd[f"layers.{i}.layers.0.weight"] = torch.from_numpy(
            np.ascontiguousarray(leaf["kernel"].transpose(3, 2, 0, 1)))
        sd[f"layers.{i}.layers.0.bias"] = torch.from_numpy(leaf["bias"])
    n, s = p["ConvLayer_0"]["norm"], st["ConvLayer_0"]["norm"]
    n["scale"] = r.uniform(0.5, 1.5, 16).astype(np.float32)
    n["bias"] = r.uniform(-0.1, 0.1, 16).astype(np.float32)
    s["mean"] = r.uniform(-0.1, 0.1, 16).astype(np.float32)
    s["var"] = r.uniform(0.5, 2.0, 16).astype(np.float32)
    sd.update({"layers.0.layers.1.weight": torch.from_numpy(n["scale"]),
               "layers.0.layers.1.bias": torch.from_numpy(n["bias"]),
               "layers.0.layers.1.running_mean": torch.from_numpy(s["mean"]),
               "layers.0.layers.1.running_var": torch.from_numpy(s["var"]),
               "layers.0.layers.1.num_batches_tracked": torch.tensor(0)})
    block.load_state_dict(sd)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jb.apply({"params": p, "batch_stats": st},
                                   jnp.asarray(x)))
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_resblock_identity_leg_route(monkeypatch):
    """Serving: conv1 on conv_chain, conv2 and the add as one conv_multi
    whose second leg is the input under a centre-tap identity."""
    block = random_norms(ResBlock(16, norm1="batch"), 20).eval()
    seen = []
    real = layers.conv_multi

    def spy(legs, weight, *args, **kw):
        seen.append((legs, weight))
        return real(legs, weight, *args, **kw)
    monkeypatch.setattr(layers, "conv_multi", spy)
    x = _x((1, 9, 10, 16), 21)
    with torch.no_grad():
        y = block(x)
        want = block.layers[1](block.layers[0](x)) + x
    (legs, weight), = seen
    assert legs[1][0] is x and weight.shape == (16, 32, 3, 3)
    eye = torch.zeros(16, 16, 3, 3)
    eye[range(16), range(16), 1, 1] = 1.0
    assert torch.equal(weight[:, 16:], eye)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=ATOL)


def test_pfnetv2_block_diagonal_fuse_net():
    """PFNetv2's serving fuse net (block-diagonal conv_multi + conv_chain,
    the residual added a leg) against the channels-into-batch fold on
    F.conv2d and against the JAX model's fusion."""
    from multi_modal_image_fusion_tpu.models import create_model as jcreate
    model = create_model("pfnetv2",
                         generator=torch.Generator().manual_seed(22)).eval()
    with torch.no_grad():
        for layer in model.fuse:
            layer.bias.uniform_(-0.2, 0.2)
    n = 2
    legs = [_x((2 * n, 10, 13, 16), 23 + i) + 0.5 for i in range(4)]
    with torch.no_grad():
        got = model.fusion(legs, n)
        fold = model._fold(torch.cat(legs, -1), n)
    assert got.shape == (n, 10, 13, 64)
    np.testing.assert_allclose(got.numpy(), fold.numpy(), atol=ATOL)
    (w0, _), (w1, _), (w2, _) = model.fuse_weights()
    assert (w0.shape, w1.shape, w2.shape) == ((128, 128, 3, 3),
                                              (128, 128, 3, 3),
                                              (64, 128, 3, 3))
    # the JAX fusion on the same weights
    jm = jcreate("pfnetv2")
    f = torch.cat(legs, -1).numpy()
    params = {f"fuse{i}": {
        "kernel": layer.weight.detach().numpy().transpose(2, 3, 1, 0),
        "bias": layer.bias.detach().numpy()}
        for i, layer in enumerate(model.fuse)}
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(f[:n]),
                                   jnp.asarray(f[n:]),
                                   method=lambda m, a, b: m.fusion(a, b)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_two_gray_leg_enter_plain():
    """The two-leg enter's plain version is F.conv2d on the images'
    channel concat; the siamese mode keeps its batch-halves behaviour."""
    a, b = _x((2, 12, 14, 1), 30), _x((2, 12, 14, 1), 31)
    wt, bias = _x((16, 2, 5, 5), 32), _x((16,), 33)
    got = conv_gray_enter(a, b, wt, bias, "lrelu")
    xn = F.pad(torch.cat([a, b], -1).permute(0, 3, 1, 2), (2,) * 4,
               mode="reflect")
    want = F.leaky_relu(F.conv2d(xn, wt, bias), 0.2).permute(0, 2, 3, 1)
    assert got.shape == (2, 12, 14, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    np.testing.assert_allclose(
        conv_gray_enter_plain(a, b, wt, bias, "lrelu").numpy(), got.numpy())
    w1 = wt[:, :1]
    sia = conv_gray_enter(a, b, w1, bias, "relu")
    assert sia.shape == (4, 12, 14, 16)
    with pytest.raises(ValueError, match="img2"):
        conv_gray_enter(a, None, wt, bias)


def test_pack_gray_enter_two_legs():
    """The two-leg B fragments: per parity, leg 0's then leg 1's, each the
    one-leg packing of its channel."""
    wt = _x((16, 2, 5, 5), 34)
    packed = pack_gray_enter(wt).view(2, 2, -1)
    for leg in range(2):
        one = pack_gray_enter(wt[:, leg:leg + 1].contiguous()).view(2, -1)
        assert torch.equal(packed[:, leg], one)


def test_exit_over_legs_plain():
    """The exit over legs [(x_l, b_off_l)] is F.conv2d on their concat at
    the offsets; the output batch is the smallest the legs feed."""
    t, u = _x((4, 9, 11, 16), 35), _x((3, 9, 11, 8), 36)
    legs = [(t, 0), (u, 1), (t, 2)]
    wt, bias = _x((1, 40, 3, 3), 37), _x((1,), 38)
    got = conv_gray_exit(legs, wt, bias, "tanh")
    cat = torch.cat([t[:2], u[1:3], t[2:4]], -1)
    xn = F.pad(cat.permute(0, 3, 1, 2), (1,) * 4, mode="reflect")
    want = torch.tanh(F.conv2d(xn, wt, bias)).permute(0, 2, 3, 1)
    assert got.shape == (2, 9, 11, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    np.testing.assert_allclose(
        conv_gray_exit_plain(legs, wt, bias, "tanh").numpy(), got.numpy())
