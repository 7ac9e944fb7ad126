"""The port's DeepFuse (plain path, CPU) against the JAX package.

Weights are the JAX model's own init, carried over by
utils/jax_convert.jax_to_state_dict. Tolerance 1e-4 everywhere (the
docs/PARITY.md model-forward budget; f32 on both sides):

- JAX `model.apply` in fusion mode (sum, mean, max), autoencoder mode and
  at the odd size 45x61;
- the JAX kernel path: MMIF_CHAIN_INTERPRET=1 + MMIF_CHAIN_HIW=1 under
  fast_inference() runs the real _chain_enter_gray / conv_hiw_chain /
  _chain_exit_gray Pallas kernels in interpret mode;
- the reference PyTorch goldens, with their state dicts loaded by name;
- the weight carry round trip JAX -> port -> convert_state_dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import nchw_to_nhwc, nhwc_to_nchw
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


def _jax_variables(model, x1, x2, seed=0):
    v = model.init(jax.random.PRNGKey(seed), jnp.asarray(x1[:1]),
                   jnp.asarray(x2[:1]), train=False)
    # non-zero biases so the bias path is exercised
    r = np.random.RandomState(seed + 100)
    params = jax.tree.map(np.asarray, v["params"])
    for leaf in params.values():
        leaf["bias"] = (0.1 * (r.rand(*leaf["bias"].shape) - 0.5)).astype(
            np.float32)
    return {"params": params}


def _port(variables, fusion_mode="sum"):
    model = create_model("deepfuse", fusion_mode=fusion_mode)
    model.load_state_dict(jax_to_state_dict(variables, "deepfuse"))
    return model.eval()


def _run(model, x1, x2=None):
    with torch.no_grad():
        y = model(torch.from_numpy(x1),
                  None if x2 is None else torch.from_numpy(x2))
    return y.numpy()


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_deepfuse_vs_jax_apply(mode):
    x1, x2 = _pair(0, 2, 32, 40)
    jm = jcreate("deepfuse", fusion_mode=mode)
    variables = _jax_variables(jm, x1, x2)
    with jax.default_matmul_precision("float32"):
        want = jm.apply(variables, jnp.asarray(x1), jnp.asarray(x2),
                        train=False)
    got = _run(_port(variables, mode), x1, x2)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("case", ["ae", "odd"])
def test_deepfuse_vs_jax_ae_and_odd(case):
    h, w = (45, 61) if case == "odd" else (32, 40)
    x1, x2 = _pair(1, 1, h, w)
    jm = jcreate("deepfuse")
    variables = _jax_variables(jm, x1, x2, seed=1)
    b = None if case == "ae" else x2
    with jax.default_matmul_precision("float32"):
        want = jm.apply(variables, jnp.asarray(x1),
                        None if b is None else jnp.asarray(b), train=False)
    got = _run(_port(variables), x1, b)
    assert got.shape == (1, h, w, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_deepfuse_vs_jax_kernel_path(monkeypatch):
    """The JAX TPU path (enter -> 5 H-major chain convs with the fuse_n
    prologue -> exit), run by the Pallas interpreter on the CPU."""
    monkeypatch.setenv("MMIF_CHAIN_INTERPRET", "1")
    monkeypatch.setenv("MMIF_CHAIN_HIW", "1")
    x1, x2 = _pair(2, 2, 24, 128)
    jm = jcreate("deepfuse")
    variables = _jax_variables(jm, x1, x2, seed=2)
    with fast_inference():
        want = jm.apply(variables, jnp.asarray(x1), jnp.asarray(x2),
                        train=False)
    got = _run(_port(variables), x1, x2)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_deepfuse_vs_reference_goldens(golden):
    """Reference PyTorch outputs; state dicts load by their own names."""
    d = golden("model_fwd_deepfuse")
    import json
    keyshapes = json.loads(bytes(d["keyshapes"]).decode())
    model = create_model("deepfuse")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synth_state_dict(keyshapes).items()})
    x1, x2 = nchw_to_nhwc(d["x1"]), nchw_to_nhwc(d["x2"])
    np.testing.assert_allclose(nhwc_to_nchw(_run(model, x1, x2)), d["y"],
                               atol=ATOL)
    np.testing.assert_allclose(nhwc_to_nchw(_run(model, x1)), d["y_ae"],
                               atol=ATOL)
    np.testing.assert_allclose(
        nhwc_to_nchw(_run(model, nchw_to_nhwc(d["x1o"]),
                          nchw_to_nhwc(d["x2o"]))), d["y_odd"], atol=ATOL)

    d = golden("model_deepfuse")
    model.load_state_dict({k[4:]: torch.from_numpy(d[k]) for k in d.files
                           if k.startswith("sd__")})
    x1, x2 = nchw_to_nhwc(d["x1"]), nchw_to_nhwc(d["x2"])
    np.testing.assert_allclose(nhwc_to_nchw(_run(model, x1, x2)), d["y"],
                               atol=ATOL)
    np.testing.assert_allclose(nhwc_to_nchw(_run(model, x1)), d["y_ae"],
                               atol=ATOL)


def test_weight_carry_round_trip():
    x1, x2 = _pair(3, 1, 16, 16)
    variables = _jax_variables(jcreate("deepfuse"), x1, x2, seed=3)
    sd = jax_to_state_dict(variables, "deepfuse")
    back = convert_state_dict("deepfuse", {k: v.numpy()
                                           for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))


def test_weight_carry_rejects_leftovers():
    x1, x2 = _pair(4, 1, 16, 16)
    variables = _jax_variables(jcreate("deepfuse"), x1, x2)
    variables["params"]["extra"] = {"kernel": np.zeros((1, 1, 1, 1))}
    with pytest.raises(ValueError):
        jax_to_state_dict(variables, "deepfuse")


def test_create_model_unported_raises():
    """What the port has not ported raises, naming ROADMAP.md: every
    MyFusion configuration builds, and the training route of a
    MetaFormer's standalone batch norm (queue 1 item 5) raises."""
    from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training
    model = create_model("myfusion", encoder="transformer")
    x = torch.rand(1, 32, 32, 1)
    with torch.no_grad(), fast_training(False), pytest.raises(
            NotImplementedError, match="ROADMAP.md"):
        model(x, x)
    with pytest.raises(ValueError):
        create_model("deepfuse", fusion_mode="l1")
