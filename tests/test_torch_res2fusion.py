"""The port's Res2Fusion (plain path, CPU) against the JAX package.

Weights are the JAX model's own init (with non-zero biases where its convs
have them; the Res2 blocks have none), made once for the file and carried
over by utils/jax_convert.jax_to_state_dict; the JAX init and forwards run
under jax.jit, so each shape compiles once. Tolerance 1e-4 (the
docs/PARITY.md model-forward budget; f32 on both sides):

- JAX `model.apply` in 'attn' fusion (double non-local attention, the
  default), 'elem' fusion and autoencoder mode, at 64x64 and the odd 45x61
  (whose 8x8 pool drops the remainder rows and columns);
- the JAX H-major serving route (MMIF_CHAIN_HIW_MULTI=1 with the Pallas
  interpreter under fast_inference: conv_hiw_chain with the depthwise
  convs as diagonal bands, conv_hiw_chain_multi over the legs); at its
  small size (at most 2^18 pixels) JAX's 'nl' pooling takes the dense
  einsum, so the nl kernel is held against JAX's in tests/test_torch_nl.py;
- the reference PyTorch goldens, state dicts loaded by their own names;
- the parameter count against tests/golden/param_counts.json;
- the weight carry round trip JAX -> port -> convert_state_dict, and its
  refusal of unused leaves.
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


def _pair(seed, b, h, w):
    r = np.random.RandomState(seed)
    return (r.rand(b, h, w, 1).astype(np.float32),
            r.rand(b, h, w, 1).astype(np.float32))


@pytest.fixture(scope="module")
def variables():
    """The JAX Res2Fusion's init (the same tree for every fusion method)
    with seeded non-zero biases, as nested numpy dicts."""
    x = jnp.zeros((1, 16, 16, 1), jnp.float32)
    v = jax.jit(functools.partial(jcreate("res2fusion").init, train=False))(
        jax.random.PRNGKey(0), x, x)
    r = np.random.RandomState(100)
    params = jax.tree.map(np.array, v["params"])

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
    model = create_model("res2fusion", **kw)
    model.load_state_dict(jax_to_state_dict(variables, "res2fusion"))
    return model.eval()


def _run(model, x1, x2=None):
    with torch.no_grad():
        y = model(torch.from_numpy(x1),
                  None if x2 is None else torch.from_numpy(x2))
    return y.numpy()


@pytest.mark.parametrize("hw", [(64, 64), (45, 61)])
@pytest.mark.parametrize("method,ae", [("attn", False), ("elem", False),
                                       ("attn", True)],
                         ids=["attn", "elem", "ae"])
def test_vs_jax_apply(variables, method, ae, hw):
    x1, x2 = _pair(0, 2, *hw)
    jm = jcreate("res2fusion", fusion_method=method)
    b = None if ae else x2
    with jax.default_matmul_precision("float32"):
        want = jax.jit(functools.partial(jm.apply, train=False))(
            variables, jnp.asarray(x1), None if b is None else jnp.asarray(b))
    got = _run(_port(variables, fusion_method=method), x1, b)
    assert got.shape == (2, *hw, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("method", ["attn", "elem"])
def test_vs_jax_hmajor_kernel_path(variables, method, monkeypatch):
    """The JAX TPU path (hiw_enter -> conv_in -> the Res2 blocks in the
    H-major layout, depthwise convs as diagonal-band dots, legs through the
    multi-leg kernel -> nl fusion in NHWC or the legs' means -> decoder ->
    exit), its conv kernels run by the Pallas interpreter on the CPU. At
    16x24 the nl fusion is JAX's dense einsum (the flash kernel runs above
    2^18 pixels)."""
    monkeypatch.setenv("MMIF_CHAIN_INTERPRET", "1")
    monkeypatch.setenv("MMIF_CHAIN_HIW_MULTI", "1")
    x1, x2 = _pair(1, 1, 16, 24)
    jm = jcreate("res2fusion", fusion_method=method)
    with fast_inference(), jax.default_matmul_precision("float32"):
        want = jm.apply(variables, jnp.asarray(x1), jnp.asarray(x2),
                        train=False)
    got = _run(_port(variables, fusion_method=method), x1, x2)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_vs_reference_goldens(golden):
    d = golden("model_fwd_res2fusion")
    keyshapes = json.loads(bytes(d["keyshapes"]).decode())
    model = create_model("res2fusion")
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
        want = json.load(f)["Res2Fusion"]
    model = create_model("res2fusion")
    assert sum(p.numel() for p in model.parameters()) == want
    with open(os.path.join(GOLDEN_DIR, "sd_shapes.json")) as f:
        shapes = json.load(f)["res2fusion"]
    assert {k: list(v.shape) for k, v in model.state_dict().items()} == shapes


def test_weight_carry_round_trip(variables):
    sd = jax_to_state_dict(variables, "res2fusion")
    assert sorted(sd) == sorted(create_model("res2fusion").state_dict())
    back = convert_state_dict("res2fusion",
                              {k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))


@pytest.mark.parametrize("where", ["top", "block"])
def test_weight_carry_rejects_leftovers(variables, where):
    tree = jax.tree.map(np.copy, variables["params"])
    if where == "top":
        tree["conv9"] = {"kernel": np.zeros((3, 3, 1, 1), np.float32)}
    else:
        tree["RB2"]["dwconv8"] = {"kernel": np.zeros((3, 3, 1, 48),
                                                     np.float32)}
    with pytest.raises(ValueError, match="unconverted"):
        jax_to_state_dict({"params": tree}, "res2fusion")


def test_unknown_fusion_method_raises():
    with pytest.raises(ValueError):
        create_model("res2fusion", fusion_method="mean")
