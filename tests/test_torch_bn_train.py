"""The batch norm's training route (ops/layers.batch_norm) on the CPU,
against the JAX package:

- a normed `ConvLayer` in train mode on every route a layer trains on (a
  k3 and a k5 lrelu conv, F.conv2d or, under `fast_training(True)`,
  conv_valid_fast; a stride-2 conv; a k3 depthwise conv; the VALID k2
  stride-2 depthwise down), against the JAX ConvLayer applied with
  `train=True, mutable=["batch_stats"]`: the output and the new running
  statistics within 2e-5, the gradients of the conv's weight and bias and
  of the norm's scale and shift within 1e-4 of the largest; in eval mode
  the same route against `train=False` (the running statistics);
- the biased-variance control: one image of 4x4 pixels, where flax's
  update (the biased variance) and torch's F.batch_norm(training=True)
  (the unbiased one, 16/15 of it) differ; the port holds flax's and
  torch's update must miss it;
- the standalone `BatchNormNHWC` in train mode against flax nn.BatchNorm
  (momentum 0.9, eps 1e-5), the same way, and its input's gradient;
- under the Trainer's `amp="bf16"` the batch statistics and the running
  buffers stay f32 (IFCNN's step moves them; the JAX Trainer casts its new
  statistics back to their dtype, train/trainer.py:155-162);
- the carry of a JAX TrainState with batch statistics (IFCNN, after one
  JAX Trainer step in float64) through `jax_train_state_to_torch`:
  parameters, statistics and Adam moments equal to the JAX state's (cast
  to f32), then one more step on both sides: loss parts within 2e-5,
  parameters within 1e-6 where the gradient is above 1e-4 of the largest
  (2 lr below it), the running statistics within 1e-5.

Inputs from numpy seeds, f32 on both sides for the layers (zero-mean
inputs: flax's E[x^2] - E[x]^2 variance is exact enough there).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import serialization
from flax.core import FrozenDict

import test_torch_step_common as sc
from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.ops.layers import ConvLayer as JConvLayer
from multi_modal_image_fusion_tpu.parallel.mesh import make_mesh, replicate
from multi_modal_image_fusion_tpu.train.schedules import \
    make_lr_schedule as jax_schedule
from multi_modal_image_fusion_tpu.train.trainer import Trainer as JTrainer
from multi_modal_image_fusion_tpu.train.trainer import TrainState
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import layers
from multi_modal_image_fusion_tpu_torch.ops.layers import (BatchNormNHWC,
                                                           ConvLayer)
from multi_modal_image_fusion_tpu_torch.train.schedules import \
    make_lr_schedule
from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import (
    jax_to_state_dict, jax_train_state_to_torch)

ATOL = 2e-5
GRAD_TOL = 1e-4

# name: (c_in, c_out, k, act, layer kwargs, input shape (b, h, w))
LAYERS = {
    "k3": (8, 16, 3, "relu", {}, (2, 9, 11)),
    "k5_lrelu": (3, 16, 5, "lrelu", {}, (2, 12, 10)),
    "stride2": (8, 16, 3, "relu", {"stride": 2}, (2, 10, 14)),
    "depthwise": (16, 16, 3, "relu6", {"groups": 16}, (2, 9, 9)),
    "valid_down": (16, 16, 2, "relu6",
                   {"groups": 16, "stride": 2, "padding": 0}, (2, 10, 12)),
}


def _x(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32) - 0.5


def _layer_pair(name, seed=0):
    """(JAX layer, its seeded variables, the port layer with them)."""
    cin, cout, k, act, kw, shape = LAYERS[name]
    jl = JConvLayer(cout, ksize=k, act=act, norm="batch", **kw)
    x = _x((*shape, cin), seed)
    v = jax.tree.map(np.array, jl.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(x)))
    r = np.random.RandomState(seed + 1)
    p, st = v["params"], v["batch_stats"]
    p["bias"] = r.uniform(-0.1, 0.1, cout).astype(np.float32)
    p["norm"] = {"scale": r.uniform(0.5, 1.5, cout).astype(np.float32),
                 "bias": r.uniform(-0.1, 0.1, cout).astype(np.float32)}
    st["norm"] = {"mean": r.uniform(-0.1, 0.1, cout).astype(np.float32),
                  "var": r.uniform(0.5, 2.0, cout).astype(np.float32)}
    layer = ConvLayer(cin, cout, k, act=act, norm="batch", **kw)
    layer.load_state_dict({
        "layers.0.weight": torch.from_numpy(np.ascontiguousarray(
            p["kernel"].transpose(3, 2, 0, 1))),
        "layers.0.bias": torch.from_numpy(p["bias"]),
        "layers.1.weight": torch.from_numpy(p["norm"]["scale"]),
        "layers.1.bias": torch.from_numpy(p["norm"]["bias"]),
        "layers.1.running_mean": torch.from_numpy(st["norm"]["mean"]),
        "layers.1.running_var": torch.from_numpy(st["norm"]["var"]),
        "layers.1.num_batches_tracked": torch.tensor(0)})
    return jl, v, layer, x


@functools.lru_cache(maxsize=None)
def _jax_layer_step(name, train):
    """The JAX layer's output, new statistics and gradients (kernel, bias,
    scale, shift) of sum(out * cot) on `_layer_pair(name)`'s input, and the
    seeded cotangent (one jit a layer and mode: the port's plain and fast
    routes share it)."""
    jl, v, _, x = _layer_pair(name)
    out_shape = jax.eval_shape(functools.partial(
        jl.apply, train=train, mutable=["batch_stats"]), v,
        jnp.asarray(x))[0].shape
    cot = np.random.RandomState(7).randn(*out_shape).astype(np.float32)

    def f(p):
        out, mut = jl.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=train,
                            mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])
    g, (out, st) = jax.jit(jax.grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, v["params"]))
    g = jax.tree.map(np.asarray, g)
    return np.asarray(out), jax.tree.map(np.asarray, st), {
        "layers.0.weight": g["kernel"].transpose(3, 2, 0, 1),
        "layers.0.bias": g["bias"], "layers.1.weight": g["norm"]["scale"],
        "layers.1.bias": g["norm"]["bias"]}, cot


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_normed_layer_vs_jax(name, fast, train):
    _, _, layer, x = _layer_pair(name)
    layer.train(train)
    bn = layer.layers[1]
    with layers.fast_training(fast):
        out = layer(torch.from_numpy(x))
    want, want_st, want_g, cot = _jax_layer_step(name, train)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL)
    assert want.std() > 1e-2
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               want_st["norm"]["mean"], atol=ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               want_st["norm"]["var"], atol=ATOL)
    assert int(bn.num_batches_tracked) == int(train)
    params = dict(layer.named_parameters())
    got = dict(zip(params, torch.autograd.grad(
        (out * torch.from_numpy(cot)).sum(), list(params.values()))))
    scale = max(float(np.abs(g).max()) for g in want_g.values())
    for k, g in got.items():
        err = float(np.abs(g.numpy() - want_g[k]).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def test_running_var_is_biased():
    """One image of 4x4 pixels: the running variance moves by flax's
    biased batch variance (the JAX step's); torch's F.batch_norm
    (training=True) stores the unbiased one, 16/15 of it, and misses."""
    jl = JConvLayer(4, ksize=3, norm="batch")
    x = _x((1, 4, 4, 2), 3)
    v = jax.tree.map(np.array, jl.init(jax.random.PRNGKey(1),
                                       jnp.asarray(x)))
    _, mut = jl.apply(v, jnp.asarray(x), train=True,
                      mutable=["batch_stats"])
    want = np.asarray(mut["batch_stats"]["norm"]["var"])
    layer = ConvLayer(2, 4, 3, norm="batch")
    layer.load_state_dict(jax_state(v))
    layer.train()
    with layers.fast_training(False):
        y = layer(torch.from_numpy(x))
    got = layer.layers[1].running_var.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # the control: the same conv output through torch's update
    p = 1
    conv = F.conv2d(F.pad(torch.from_numpy(x).permute(0, 3, 1, 2),
                          (p,) * 4, mode="reflect"), layer.weight,
                    layer.bias).detach()
    r_mean, r_var = torch.zeros(4), torch.ones(4)
    F.batch_norm(conv, r_mean, r_var, training=True, momentum=0.1, eps=1e-5)
    var = conv.var(dim=(0, 2, 3), correction=0)
    np.testing.assert_allclose(r_var.numpy() - 0.9, 0.1 * var.numpy() * 16
                               / 15, rtol=1e-5)
    assert np.abs(r_var.numpy() - want).max() > 100 * 1e-5 * want.max()
    assert y.shape == (1, 4, 4, 4)


def jax_state(v):
    """A JAX ConvLayer's variables -> the port layer's state dict."""
    p, st = v["params"], v["batch_stats"]
    return {"layers.0.weight": torch.from_numpy(np.ascontiguousarray(
                np.asarray(p["kernel"]).transpose(3, 2, 0, 1))),
            "layers.0.bias": torch.from_numpy(np.asarray(p["bias"])),
            "layers.1.weight": torch.from_numpy(np.asarray(
                p["norm"]["scale"])),
            "layers.1.bias": torch.from_numpy(np.asarray(p["norm"]["bias"])),
            "layers.1.running_mean": torch.from_numpy(np.asarray(
                st["norm"]["mean"])),
            "layers.1.running_var": torch.from_numpy(np.asarray(
                st["norm"]["var"])),
            "layers.1.num_batches_tracked": torch.tensor(0)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_standalone_batch_norm_vs_flax(train):
    """BatchNormNHWC on its training route against flax nn.BatchNorm
    (momentum 0.9, eps 1e-5): output, new statistics, the gradients of the
    scale, the shift and the input."""
    r = np.random.RandomState(21)
    x = (r.rand(2, 6, 7, 16) * 2 - 0.5).astype(np.float32)
    cot = r.randn(*x.shape).astype(np.float32)
    p = {"scale": r.uniform(0.5, 1.5, 16).astype(np.float32),
         "bias": r.uniform(-0.1, 0.1, 16).astype(np.float32)}
    st = {"mean": r.uniform(-0.1, 0.1, 16).astype(np.float32),
          "var": r.uniform(0.5, 2.0, 16).astype(np.float32)}
    jb = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5)

    def f(p, x):
        out, mut = jb.apply({"params": p, "batch_stats": st}, x,
                            mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])
    (gp, gx), (want, want_st) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(x))
    bn = BatchNormNHWC(16)
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(st["mean"]),
                        "running_var": torch.from_numpy(st["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    out = bn(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    for key, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(want_st[key]),
                                   atol=ATOL)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              (bn.weight, bn.bias, xt))
    want_g = [np.asarray(gp["scale"]), np.asarray(gp["bias"]),
              np.asarray(gx)]
    scale = max(float(np.abs(g).max()) for g in want_g)
    for a, b in zip(got, want_g):
        assert float(np.abs(a.numpy() - b).max()) <= GRAD_TOL * scale


def test_bf16_step_keeps_f32_statistics():
    model = sc.port_model("ifcnn", {}, sc.variables("ifcnn"))
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    pt = Trainer(model, make_lr_schedule(*sc.SCHED), amp="bf16", fast=True)
    parts, imgf = pt.train_step(tuple(map(torch.from_numpy, sc.batch(3))))
    assert imgf.dtype == torch.float32 and np.isfinite(float(parts["loss"]))
    for k, v in before.items():
        now = model.state_dict()[k]
        assert now.dtype == torch.float32 and not torch.equal(now, v), k


# --- the carry of a JAX TrainState with batch statistics (IFCNN) -----------

CARRY = "ifcnn"


@functools.lru_cache(maxsize=None)
def _jax_carry():
    """A JAX Trainer's step in float64 from the harness's seeded IFCNN
    (conv biases and batch norms non-trivial); the state after it as a
    checkpoint stores it (flax msgpack), and the next step's state, loss
    parts and batch."""
    v = sc.variables(CARRY)
    jt = JTrainer(jcreate(CARRY), jax_schedule(*sc.SCHED),
                  mesh=make_mesh(jax.devices()[:1]))
    with jax.enable_x64(True):
        p, st = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v[k])
                 for k in ("params", "batch_stats"))
        state = replicate(TrainState(
            step=jnp.zeros((), jnp.int32), params=p,
            batch_stats=FrozenDict(st), opt_state=jt.tx.init(p)), jt.mesh)
        x = [tuple(jnp.asarray(a, jnp.float64) for a in sc.batch(s))
             for s in (13, 14)]
        state, _, _ = jt.train_step(state, x[0])
        blob = serialization.to_bytes(jax.device_get(state))
        state, parts, _ = jt.train_step(state, x[1])
        after = jax.tree.map(np.asarray, jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}))
    return (serialization.msgpack_restore(blob), after,
            {k: float(a) for k, a in parts.items()})


def test_train_state_with_batch_stats_carries():
    restored, after, jparts = _jax_carry()
    sd, opt = jax_train_state_to_torch(restored, CARRY)
    assert opt["step"] == 1
    want = jax_to_state_dict(jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        {k: restored[k] for k in ("params", "batch_stats")}), CARRY)
    assert sorted(sd) == sorted(want)
    for k, t in sd.items():
        assert torch.equal(t, want[k]), k
    assert any("running_var" in k for k in sd)
    model = create_model(CARRY)
    model.load_state_dict(sd)
    pt = Trainer(model, make_lr_schedule(*sc.SCHED))
    pt.load_state_dict(opt)
    assert sorted(pt.mu) == sorted(pt.nu) == sorted(pt.params)
    seen = {}
    update = pt._update

    def spy(grads):
        seen.update(zip(pt.params, grads))
        return update(grads)
    pt._update = spy
    parts, _ = pt.train_step(tuple(map(torch.from_numpy, sc.batch(14))))
    for k in ("loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(parts[k]), jparts[k],
                                   atol=sc.PARTS_ATOL)
    assert pt.step == 2
    want = jax_to_state_dict(after, CARRY)
    scale = max(float(g.abs().max()) for g in seen.values())
    for k, t in model.state_dict().items():
        kind = k.rsplit(".", 1)[-1]
        diff = (t.double() - want[k].double()).abs()
        if kind == "num_batches_tracked":
            assert int(t) in (1, 2), k      # the encoder's, once a modality
        elif kind in ("running_mean", "running_var"):
            assert float(diff.max()) <= sc.STATS_TOL * max(
                1.0, float(want[k].abs().max())), k
        else:
            loose = seen[k].abs() < sc.GRAD_TOL * scale
            assert float(torch.where(loose, 0.0, diff).max()) <= \
                sc.PARAM_ATOL, k
            assert float(diff.max()) <= 2 * sc.LR, k


def test_train_state_rejects_stats_leftovers():
    """A batch_stats leaf the carry does not use raises."""
    restored, _, _ = _jax_carry()
    state = dict(restored)
    state["batch_stats"] = dict(state["batch_stats"], extra={
        "norm": {"mean": np.zeros(3), "var": np.ones(3)}})
    with pytest.raises(ValueError, match="unconverted"):
        jax_train_state_to_torch(state, CARRY)
