"""The port's DenseFuse and VIFNet (plain path, CPU) against the JAX package.

Weights are the JAX models' own init (with non-zero biases), carried over by
utils/jax_convert.jax_to_state_dict. Tolerance 1e-4 (the docs/PARITY.md
model-forward budget; f32 on both sides):

- JAX `model.apply`: DenseFuse in 'sum' and 'l1' fusion and autoencoder
  mode, VIFNet, at 64x64 and the odd 45x61;
- the JAX multi-leg kernel path (MMIF_CHAIN_HIW_MULTI=1 with the Pallas
  interpreter under fast_inference: conv_hiw_chain over the dense legs,
  conv_hiw_chain_multi for dec0);
- the reference PyTorch goldens, state dicts loaded by their own names;
- parameter counts against tests/golden/param_counts.json;
- the weight carry round trip JAX -> port -> convert_state_dict, and its
  refusal of unused leaves;
- one DenseFuse train step on the port's training route (the legs
  concatenated, F.conv2d) against one JAX train step: gradients within 1e-4
  of the largest, loss parts within 2e-5, parameters within 1e-6, as
  tests/test_torch_train.py holds DeepFuse.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR, nchw_to_nhwc, nhwc_to_nchw
from param_synth import synth_state_dict

from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.ops.layers import fast_inference
from multi_modal_image_fusion_tpu.parallel.mesh import make_mesh
from multi_modal_image_fusion_tpu.train.schedules import \
    make_lr_schedule as jax_schedule
from multi_modal_image_fusion_tpu.train.trainer import Trainer as JTrainer
from multi_modal_image_fusion_tpu.utils.torch_convert import \
    convert_state_dict
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training
from multi_modal_image_fusion_tpu_torch.train.schedules import \
    make_lr_schedule
from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

ATOL = 1e-4


def _pair(seed, b, h, w):
    r = np.random.RandomState(seed)
    return (r.rand(b, h, w, 1).astype(np.float32),
            r.rand(b, h, w, 1).astype(np.float32))


def _jax_variables(model, x1, x2, seed=0):
    v = model.init(jax.random.PRNGKey(seed), jnp.asarray(x1[:1]),
                   jnp.asarray(x2[:1]), train=False)
    r = np.random.RandomState(seed + 100)
    params = jax.tree.map(np.asarray, v["params"])

    def with_bias(tree):
        for leaf in tree.values():
            if "kernel" in leaf:
                leaf["bias"] = (0.1 * (r.rand(*leaf["bias"].shape)
                                       - 0.5)).astype(np.float32)
            else:
                with_bias(leaf)
    with_bias(params)
    return {"params": params}


def _port(name, variables, **kw):
    model = create_model(name, **kw)
    model.load_state_dict(jax_to_state_dict(variables, name))
    return model.eval()


def _run(model, x1, x2=None):
    with torch.no_grad():
        y = model(torch.from_numpy(x1),
                  None if x2 is None else torch.from_numpy(x2))
    return y.numpy()


_CASES = [("densefuse", {"fusion_mode": "sum"}, False),
          ("densefuse", {"fusion_mode": "l1"}, False),
          ("densefuse", {"fusion_mode": "sum"}, True),
          ("vifnet", {}, False)]


@pytest.mark.parametrize("hw", [(64, 64), (45, 61)])
@pytest.mark.parametrize("name,kw,ae", _CASES,
                         ids=["densefuse-sum", "densefuse-l1",
                              "densefuse-ae", "vifnet"])
def test_vs_jax_apply(name, kw, ae, hw):
    x1, x2 = _pair(0, 2, *hw)
    jm = jcreate(name, **kw)
    variables = _jax_variables(jm, x1, x2)
    b = None if ae else x2
    with jax.default_matmul_precision("float32"):
        want = jm.apply(variables, jnp.asarray(x1),
                        None if b is None else jnp.asarray(b), train=False)
    got = _run(_port(name, variables, **kw), x1, b)
    assert got.shape == (2, *hw, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["densefuse", "vifnet"])
def test_vs_jax_multi_leg_kernel_path(name, monkeypatch):
    """The JAX TPU path (hiw_enter -> dense legs through the multi-leg
    kernel -> dec0 over the legs with fuse_n or b_offs -> chain -> exit),
    run by the Pallas interpreter on the CPU."""
    monkeypatch.setenv("MMIF_CHAIN_INTERPRET", "1")
    monkeypatch.setenv("MMIF_CHAIN_HIW_MULTI", "1")
    x1, x2 = _pair(1, 2, 24, 40)
    jm = jcreate(name)
    variables = _jax_variables(jm, x1, x2, seed=1)
    with fast_inference():
        want = jm.apply(variables, jnp.asarray(x1), jnp.asarray(x2),
                        train=False)
    got = _run(_port(name, variables), x1, x2)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["densefuse", "vifnet"])
def test_vs_reference_goldens(golden, name):
    d = golden(f"model_fwd_{name}")
    keyshapes = json.loads(bytes(d["keyshapes"]).decode())
    model = create_model(name)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synth_state_dict(keyshapes).items()})
    model.eval()
    x1, x2 = nchw_to_nhwc(d["x1"]), nchw_to_nhwc(d["x2"])
    np.testing.assert_allclose(nhwc_to_nchw(_run(model, x1, x2)), d["y"],
                               atol=ATOL)
    np.testing.assert_allclose(
        nhwc_to_nchw(_run(model, nchw_to_nhwc(d["x1o"]),
                          nchw_to_nhwc(d["x2o"]))), d["y_odd"], atol=ATOL)
    if "y_ae" in d.files:
        np.testing.assert_allclose(nhwc_to_nchw(_run(model, x1)), d["y_ae"],
                                   atol=ATOL)
    if name == "densefuse":
        d = golden("model_densefuse")
        model.load_state_dict({k[4:]: torch.from_numpy(d[k]) for k in d.files
                               if k.startswith("sd__")})
        x1, x2 = nchw_to_nhwc(d["x1"]), nchw_to_nhwc(d["x2"])
        np.testing.assert_allclose(nhwc_to_nchw(_run(model, x1, x2)),
                                   d["y"], atol=ATOL)
        np.testing.assert_allclose(nhwc_to_nchw(_run(model, x1)), d["y_ae"],
                                   atol=ATOL)


@pytest.mark.parametrize("name,key", [("deepfuse", "DeepFuse"),
                                      ("densefuse", "DenseFuse"),
                                      ("vifnet", "VIFNet")])
def test_param_counts(name, key):
    with open(os.path.join(GOLDEN_DIR, "param_counts.json")) as f:
        want = json.load(f)[key]
    assert sum(p.numel() for p in create_model(name).parameters()) == want


@pytest.mark.parametrize("name", ["densefuse", "vifnet"])
def test_weight_carry_round_trip(name):
    x1, x2 = _pair(3, 1, 16, 16)
    variables = _jax_variables(jcreate(name), x1, x2, seed=3)
    sd = jax_to_state_dict(variables, name)
    assert sorted(sd) == sorted(create_model(name).state_dict())
    back = convert_state_dict(name, {k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))


@pytest.mark.parametrize("where", ["top", "dense"])
def test_weight_carry_rejects_leftovers(where):
    x1, x2 = _pair(4, 1, 16, 16)
    variables = _jax_variables(jcreate("densefuse"), x1, x2)
    tree = variables["params"]
    if where == "dense":
        tree = tree["dense"]
    tree["conv9"] = {"kernel": np.zeros((3, 3, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="unconverted"):
        jax_to_state_dict(variables, "densefuse")


def test_vifnet_has_no_autoencoder_mode():
    with pytest.raises(ValueError, match="autoencoder"):
        create_model("vifnet")(torch.zeros(1, 8, 8, 1))


def test_densefuse_train_step_matches_jax():
    """One train step of DenseFuse through the port's training route
    (ConvLayer concatenates the dense legs, then F.conv2d) against the JAX
    Trainer from the same init and batch."""
    sched = (1e-4, 10, 12)
    jt = JTrainer(jcreate("densefuse"), jax_schedule(*sched),
                  mesh=make_mesh(jax.devices()[:1]))
    x1, x2 = _pair(5, 2, 32, 32)
    state = jt.init_state(jax.random.PRNGKey(0), (x1, x2))
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    model = create_model("densefuse")
    model.load_state_dict(jax_to_state_dict({"params": params},
                                            "densefuse"))
    pt = Trainer(model, make_lr_schedule(*sched))
    jx1, jx2 = jnp.asarray(x1), jnp.asarray(x2)
    tx1, tx2 = torch.from_numpy(x1), torch.from_numpy(x2)

    def loss_fn(p):
        return jt.loss_bundle(jx1, jx2, jt.model.apply(
            {"params": p}, jx1, jx2, train=True))[0]
    jg = jax_to_state_dict({"params": jax.tree.map(
        np.asarray, jax.grad(loss_fn)(state.params))}, "densefuse")
    with fast_training(False):
        total, _ = pt.loss_bundle(tx1, tx2, pt.model(tx1, tx2))
        pg = dict(zip(pt.params, torch.autograd.grad(
            total, list(pt.params.values()))))
    scale = max(float(g.abs().max()) for g in jg.values())
    for k, g in pg.items():
        assert float((g - jg[k]).abs().max()) <= 1e-4 * scale, k

    state, jparts, _ = jt.train_step(state, (jx1, jx2))
    parts, imgf = pt.train_step((tx1, tx2))
    for k in ("loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   atol=2e-5)
    jp = jax_to_state_dict({"params": jax.tree.map(
        np.asarray, jax.device_get(state.params))}, "densefuse")
    for k, v in pt.model.state_dict().items():
        # Adam's first step moves a parameter by lr * g / (|g| + eps):
        # held to 1e-6 wherever the gradient is above the gradient
        # tolerance, as tests/test_torch_train.py does
        loose = jg[k].abs() < 1e-4 * scale
        diff = (v - jp[k]).abs()
        assert float(torch.where(loose, 0.0, diff).max()) <= 1e-6, k
        assert float(diff.max()) <= 2e-4, k
    assert int(state.step) == pt.step == 1
    assert imgf.shape == (2, 32, 32, 1)


def test_bench_model_flag():
    """The bench takes --model from the zoo and measures only the card."""
    from multi_modal_image_fusion_tpu_torch import bench
    with pytest.raises(SystemExit):
        bench.main(["--model", "fusiongan"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(["--model", "vifnet"])
