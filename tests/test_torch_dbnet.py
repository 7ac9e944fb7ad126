"""The port's DBNet (plain path, CPU) against the JAX package.

Weights are the JAX model's own init with seeded non-zero biases, made once
for the file and carried over by utils/jax_convert.jax_to_state_dict; the
JAX side runs under jax.jit, one compile a shape and fusion mode.
Tolerance 1e-4 (the docs/PARITY.md model-forward budget; f32 on both
sides):

- JAX `model.apply` in 'sum' (the default) and 'avg' fusion and
  autoencoder mode at 32x32 and the odd 45x57 (whose semantic branch,
  6x8 after three stride-2 convs, upsamples x8 to 48x64 and crops);
- the JAX chain serving route (MMIF_CHAIN_INTERPRET=1 under fast_inference:
  the NHWC encoder, then fusion and the decoder in the C-major guard
  layout, dec0-dec3 through conv_tlane_chain in the Pallas interpreter) at
  30x44, both fusion modes;
- the reference PyTorch goldens (y, y_odd, y_ae);
- the parameter count and the state-dict names and shapes;
- the weight carry round trip and its refusal of unused leaves.
"""

import functools
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
from multi_modal_image_fusion_tpu.utils.torch_convert import \
    convert_state_dict
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

ATOL = 1e-4
NAME = "dbnet"


def _pair(seed, b, h, w):
    r = np.random.RandomState(seed)
    return (r.rand(b, h, w, 1).astype(np.float32),
            r.rand(b, h, w, 1).astype(np.float32))


@pytest.fixture(scope="module")
def variables():
    """The JAX DBNet's init (the same tree for both fusion modes) with
    seeded non-zero biases, as nested numpy dicts."""
    x = jnp.zeros((1, 32, 32, 1), jnp.float32)
    v = jax.jit(functools.partial(jcreate(NAME).init, train=False))(
        jax.random.PRNGKey(0), x, x)
    params = jax.tree.map(np.array, v["params"])
    r = np.random.RandomState(100)

    def with_bias(tree):
        for leaf in tree.values():
            if "bias" in leaf:
                leaf["bias"] = (0.1 * (r.rand(*leaf["bias"].shape)
                                       - 0.5)).astype(np.float32)
            elif "kernel" not in leaf:
                with_bias(leaf)
    with_bias(params)
    return {"params": params}


def _port(variables, **kw):
    model = create_model(NAME, **kw)
    model.load_state_dict(jax_to_state_dict(variables, NAME))
    return model.eval()


def _run(model, x1, x2=None):
    with torch.no_grad():
        y = model(torch.from_numpy(x1),
                  None if x2 is None else torch.from_numpy(x2))
    return y.numpy()


@pytest.mark.parametrize("hw", [(32, 32), (45, 57)])
@pytest.mark.parametrize("mode,ae", [("sum", False), ("avg", False),
                                     ("sum", True)],
                         ids=["sum", "avg", "ae"])
def test_vs_jax_apply(variables, mode, ae, hw):
    x1, x2 = _pair(0, 2, *hw)
    jm = jcreate(NAME, fusion_mode=mode)
    b = None if ae else x2
    with jax.default_matmul_precision("float32"):
        want = jax.jit(functools.partial(jm.apply, train=False))(
            variables, jnp.asarray(x1), None if b is None else jnp.asarray(b))
    got = _run(_port(variables, fusion_mode=mode), x1, b)
    assert got.shape == (2, *hw, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mode", ["sum", "avg"])
def test_vs_jax_chain_route(variables, mode, monkeypatch):
    """The JAX serving route of this blocklisted model (hiw_kernel.py:72
    HIW_MULTI_BLOCKLIST keeps it off the H-major path): dec0-dec3 through
    conv_tlane_chain in the Pallas interpreter, as tests/test_pallas.py
    runs it."""
    monkeypatch.setenv("MMIF_CHAIN_INTERPRET", "1")
    x1, x2 = _pair(1, 1, 30, 44)
    jm = jcreate(NAME, fusion_mode=mode)
    with fast_inference(), jax.default_matmul_precision("float32"):
        want = jm.apply(variables, jnp.asarray(x1), jnp.asarray(x2),
                        train=False)
    got = _run(_port(variables, fusion_mode=mode), x1, x2)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_vs_reference_goldens(golden):
    d = golden(f"model_fwd_{NAME}")
    keyshapes = json.loads(bytes(d["keyshapes"]).decode())
    model = create_model(NAME)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synth_state_dict(keyshapes).items()})
    model.eval()
    x1, x2 = nchw_to_nhwc(d["x1"]), nchw_to_nhwc(d["x2"])
    np.testing.assert_allclose(nhwc_to_nchw(_run(model, x1, x2)), d["y"],
                               atol=ATOL)
    np.testing.assert_allclose(
        nhwc_to_nchw(_run(model, nchw_to_nhwc(d["x1o"]),
                          nchw_to_nhwc(d["x2o"]))), d["y_odd"], atol=ATOL)
    np.testing.assert_allclose(nhwc_to_nchw(_run(model, x1)), d["y_ae"],
                               atol=ATOL)


def test_param_count_and_names():
    with open(os.path.join(GOLDEN_DIR, "param_counts.json")) as f:
        want = json.load(f)["DBNet"]
    model = create_model(NAME)
    assert sum(p.numel() for p in model.parameters()) == want
    with open(os.path.join(GOLDEN_DIR, "sd_shapes.json")) as f:
        shapes = json.load(f)[NAME]
    assert {k: list(v.shape) for k, v in model.state_dict().items()} == shapes


def test_weight_carry_round_trip(variables):
    sd = jax_to_state_dict(variables, NAME)
    assert sorted(sd) == sorted(create_model(NAME).state_dict())
    back = convert_state_dict(NAME, {k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))


@pytest.mark.parametrize("where", ["top", "block"])
def test_weight_carry_rejects_leftovers(variables, where):
    tree = jax.tree.map(np.copy, variables["params"])
    extra = {"kernel": np.zeros((3, 3, 1, 1), np.float32)}
    if where == "top":
        tree["semantic3"] = extra
    else:
        tree["detail1"]["conv3"] = extra
    with pytest.raises(ValueError, match="unconverted"):
        jax_to_state_dict({"params": tree}, NAME)


def test_unknown_fusion_mode_raises():
    with pytest.raises(ValueError):
        create_model(NAME, fusion_mode="max")
