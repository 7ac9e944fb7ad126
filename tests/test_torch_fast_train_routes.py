"""The port's `fast_training(True)` routes (CPU) against the JAX package's.

The JAX package lets only dense, stride-1 k3, k5 and k7 convs take its
VALID conv kernel under fast training (`ops/layers.py:165-176
_pallas_conv_eligible`); every other conv trains on XLA's conv. The port
follows that gate: `conv_valid` / `conv_valid_fast` for the dense k3/5/7
layers, F.conv2d for depthwise and k1 layers.

- One Res2Fusion train step (two pairs of 32x32x1 uniform, seeded with
  numpy, the JAX init carried over by utils/jax_convert) inside
  `fast_training(True)` against the JAX `Trainer(fast=True)`: the
  gradients of the step's loss leaf by leaf, each within 1e-4 of its
  leaf's max|g| (f32 convs and losses summed in other orders); the loss
  parts within 1e-4 and every one of the 30 parameters after the step
  within 1e-4 (Adam's first update is lr * g / (|g| + 1e-8) with lr 1e-4,
  so this checks each gradient's sign: the gradient test checks its
  size); the two dead `dwconv` weights of Res2ConvBlock, which the loss
  does not reach, get a zero gradient and stay put on both sides;
- every conv of that step that reaches `conv_valid_fast` is dense and k3,
  k5 or k7, and Res2Fusion's depthwise and k1 layers reach neither
  `conv_valid` nor `conv_valid_fast`;
- a k1 layer of UNFusion (an ECB's conv1 over its legs) inside
  `fast_training(True)` equals F.conv2d on the legs' concat, values and
  weight gradient, at 2e-5 (the layer budget).
"""

import jax
import numpy as np
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.parallel.mesh import make_mesh
from multi_modal_image_fusion_tpu.train.schedules import \
    make_lr_schedule as jax_schedule
from multi_modal_image_fusion_tpu.train.trainer import Trainer as JTrainer
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import layers
from multi_modal_image_fusion_tpu_torch.ops.layers import (ConvLayer,
                                                           fast_training)
from multi_modal_image_fusion_tpu_torch.train.schedules import \
    make_lr_schedule
from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

TOL = 1e-4
SCHED = (1e-4, 10, 12)


def _pairs(seed, n=2, h=32, w=32):
    r = np.random.RandomState(seed)
    return (r.rand(n, h, w, 1).astype(np.float32),
            r.rand(n, h, w, 1).astype(np.float32))


def _spy(monkeypatch):
    """Record the weight shape of every conv_valid / conv_valid_fast call
    that ConvLayer makes."""
    seen = {"conv_valid": [], "conv_valid_fast": []}
    for name in seen:
        real = getattr(layers, name)

        def spy(xp, weight, *args, _real=real, _name=name, **kw):
            seen[_name].append(tuple(weight.shape))
            return _real(xp, weight, *args, **kw)
        monkeypatch.setattr(layers, name, spy)
    return seen


def _res2fusion_pair():
    """The JAX Trainer(fast=True) with its initial state, the same weights
    in the port's Trainer(fast=True), the inputs, the initial parameters."""
    x1, x2 = _pairs(0)
    jt = JTrainer(jcreate("res2fusion"), jax_schedule(*SCHED),
                  mesh=make_mesh(jax.devices()[:1]), fast=True)
    state = jt.init_state(jax.random.PRNGKey(0), (x1, x2))
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    model = create_model("res2fusion")
    model.load_state_dict(jax_to_state_dict({"params": params},
                                            "res2fusion"))
    pt = Trainer(model, make_lr_schedule(*SCHED), fast=True)
    return jt, state, pt, (x1, x2), params


def test_res2fusion_fast_gradients_match_jax():
    """The gradients of one Res2Fusion fast step, leaf by leaf: the port's
    torch.autograd.grad of the step's loss against jax.grad of the JAX
    step's loss (inside fast_training(True) on both sides), each within
    1e-4 of its leaf's max|g|; the dead dwconv leaves are zero on both."""
    jt, state, pt, (x1, x2), _ = _res2fusion_pair()
    j1, j2 = jax.numpy.asarray(x1), jax.numpy.asarray(x2)

    def jloss(p):
        imgf, _ = jt._apply(p, state.batch_stats, j1, j2, train=True)
        return jt.loss_bundle(j1, j2, imgf)[0]

    with jt._fast_scope():
        jg = jax.jit(jax.grad(jloss))(state.params)
    want = jax_to_state_dict({"params": jax.tree.map(
        np.asarray, jax.device_get(jg))}, "res2fusion")
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    with fast_training(True):
        total, _ = pt.loss_bundle(t1, t2, pt._apply(t1, t2, train=True))
        got = dict(zip(pt.params, torch.autograd.grad(
            total, list(pt.params.values()), materialize_grads=True)))
    assert sorted(got) == sorted(want)
    zero = []
    for k, g in got.items():
        scale = float(want[k].abs().max())
        assert float((g - want[k]).abs().max()) <= TOL * scale, (k, scale)
        if scale == 0:
            zero.append(k)
    assert zero == ["RB1.dwconv.layers.0.weight",
                    "RB2.dwconv.layers.0.weight"]


def test_res2fusion_fast_step_matches_jax(monkeypatch):
    jt, state, pt, (x1, x2), params = _res2fusion_pair()
    model = pt.model
    seen = _spy(monkeypatch)

    state, jparts, _ = jt.train_step(state, (x1, x2))
    parts, _ = pt.train_step((torch.from_numpy(x1), torch.from_numpy(x2)))

    for k in ("loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   atol=TOL)
    jp = jax_to_state_dict({"params": jax.tree.map(
        np.asarray, jax.device_get(state.params))}, "res2fusion")
    init = jax_to_state_dict({"params": params}, "res2fusion")
    sd = pt.model.state_dict()
    assert sorted(sd) == sorted(jp)
    for k, v in sd.items():
        assert float((v - jp[k]).abs().max()) <= TOL, k
        # updated on both sides or on neither (Res2ConvBlock's dead dwconv
        # gets a zero gradient on both)
        assert torch.equal(v, init[k]) == torch.equal(jp[k], init[k]), k
    still = sorted(k for k, v in sd.items() if torch.equal(v, init[k]))
    assert still == ["RB1.dwconv.layers.0.weight",
                     "RB2.dwconv.layers.0.weight"]
    # the kernel route took only what the JAX gate admits; the depthwise and
    # k1 layers trained on F.conv2d
    assert seen["conv_valid_fast"]
    dense = {(m.out_ch, m.in_ch, m.ksize, m.ksize)
             for m in model.modules() if isinstance(m, ConvLayer)
             and m.groups == 1 and m.ksize in (3, 5, 7) and m.stride == 1}
    assert set(seen["conv_valid_fast"]) <= dense
    assert all(s[-1] in (3, 5, 7) for s in seen["conv_valid_fast"])
    assert not seen["conv_valid"]


def test_res2fusion_dw_and_k1_layers_skip_conv_valid(monkeypatch):
    """Each depthwise and k1 layer of Res2Fusion, called inside
    fast_training(True) with a gradient, reaches no conv_valid route and
    equals its F.conv2d route outside the scope."""
    model = create_model("res2fusion")
    picked = [m for m in model.modules() if isinstance(m, ConvLayer)
              and (m.groups != 1 or m.ksize == 1)]
    assert any(m.groups != 1 for m in picked)
    assert any(m.ksize == 1 for m in picked)
    seen = _spy(monkeypatch)
    r = np.random.RandomState(3)
    for m in picked:
        x = torch.from_numpy(r.rand(2, 9, 11, m.in_ch).astype(np.float32))
        with fast_training(True):
            got = m(x)
        with fast_training(False):
            want = m(x)
        assert got.grad_fn is not None
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), atol=2e-5)
    assert seen == {"conv_valid": [], "conv_valid_fast": []}


def test_unfusion_k1_layer_is_conv2d():
    model = create_model("unfusion")
    k1 = [m for m in model.modules()
          if isinstance(m, ConvLayer) and m.ksize == 1 and m.wide]
    assert k1
    layer = k1[0]
    r = np.random.RandomState(4)
    widths = [layer.in_ch // 2, layer.in_ch - layer.in_ch // 2]
    legs = [(torch.from_numpy(r.rand(2, 10, 13, c).astype(np.float32)), 0)
            for c in widths]
    with torch.no_grad():
        layer.bias.uniform_(-0.1, 0.1)
    with fast_training(True):
        got = layer(legs)
    got.sum().backward()
    g_got = layer.weight.grad.clone()
    layer.weight.grad = None

    w = layer.weight.detach().clone().requires_grad_(True)
    x = torch.cat([t for t, _ in legs], -1).permute(0, 3, 1, 2)
    want = F.conv2d(x, w, layer.bias.detach())
    want = layers.apply_act(want, layer.act).permute(0, 2, 3, 1)
    want.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(g_got.numpy(), w.grad.numpy(), rtol=2e-5,
                               atol=2e-5 * float(w.grad.abs().max()))
