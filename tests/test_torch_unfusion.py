"""The port's UNFusion (plain path, CPU) against the JAX package.

Weights are the JAX model's own init with seeded non-zero biases, made once
for the file and carried over by utils/jax_convert.jax_to_state_dict; the
JAX side runs under jax.jit, one compile a shape (fusion and autoencoder
outputs come from one compile). Tolerance 1e-4 (the docs/PARITY.md
model-forward budget; f32 on both sides):

- JAX `model.apply` in 'wavg' fusion (the default) and autoencoder mode at
  32x32 and the odd 45x57 (whose stride-2 scales 23x29, 12x15, 6x8 come
  back through x2 upsamples that crop), and in maxpool / nearest mode;
- the JAX chain serving route (MMIF_CHAIN_INTERPRET=1 under fast_inference:
  the NHWC encoder, per-scale fusion in the C-major guard layout, the
  nested decoder's convs through conv_tlane_chain in the Pallas
  interpreter as summed per-part convs) at 30x44;
- the reference PyTorch goldens (y, y_odd, y_ae), state dicts loaded by
  their own names;
- the parameter count and the state-dict names and shapes;
- the weight carry round trip JAX -> port -> convert_state_dict, and its
  refusal of unused leaves at any depth.
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
NAME = "unfusion"


def _pair(seed, b, h, w):
    r = np.random.RandomState(seed)
    return (r.rand(b, h, w, 1).astype(np.float32),
            r.rand(b, h, w, 1).astype(np.float32))


def _with_bias(tree, r):
    for leaf in tree.values():
        if "bias" in leaf:
            leaf["bias"] = (0.1 * (r.rand(*leaf["bias"].shape)
                                   - 0.5)).astype(np.float32)
        elif "kernel" not in leaf:
            _with_bias(leaf, r)


@functools.lru_cache(maxsize=None)
def _variables(**cfg):
    """The JAX init of a configuration with seeded non-zero biases, as
    nested numpy dicts."""
    x = jnp.zeros((1, 32, 32, 1), jnp.float32)
    v = jax.jit(functools.partial(jcreate(NAME, **cfg).init, train=False))(
        jax.random.PRNGKey(0), x, x)
    params = jax.tree.map(np.array, v["params"])
    _with_bias(params, np.random.RandomState(100))
    return {"params": params}


@pytest.fixture(scope="module")
def variables():
    return _variables()


@functools.lru_cache(maxsize=None)
def _jax_outputs(hw, **cfg):
    """(fused, autoencoder) outputs of the JAX model, one jit."""
    x1, x2 = _pair(0, 2, *hw)
    jm = jcreate(NAME, **cfg)

    def both(v, a, b):
        return (jm.apply(v, a, b, train=False), jm.apply(v, a, train=False))
    with jax.default_matmul_precision("float32"):
        y, y_ae = jax.jit(both)(_variables(**cfg), jnp.asarray(x1),
                                jnp.asarray(x2))
    return np.asarray(y), np.asarray(y_ae)


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
@pytest.mark.parametrize("ae", [False, True], ids=["wavg", "ae"])
def test_vs_jax_apply(variables, ae, hw):
    x1, x2 = _pair(0, 2, *hw)
    want = _jax_outputs(hw)[1 if ae else 0]
    got = _run(_port(variables), x1, None if ae else x2)
    assert got.shape == (2, *hw, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_vs_jax_apply_maxpool_nearest():
    """down_mode 'maxpool' (no down convs) and up_mode 'nearest' at 45x57,
    whose 2x2 pools drop the odd row and column and whose upsamples pad."""
    cfg = dict(down_mode="maxpool", up_mode="nearest")
    x1, x2 = _pair(0, 2, 45, 57)
    got = _run(_port(_variables(**cfg), **cfg), x1, x2)
    np.testing.assert_allclose(got, _jax_outputs((45, 57), **cfg)[0],
                               atol=ATOL)


def test_vs_jax_chain_route(variables, monkeypatch):
    """The JAX serving route of this blocklisted model (hiw_kernel.py:72
    HIW_MULTI_BLOCKLIST keeps it off the H-major path): conv_tlane_chain in
    the Pallas interpreter for the nested decoder, as tests/test_pallas.py
    runs it."""
    monkeypatch.setenv("MMIF_CHAIN_INTERPRET", "1")
    x1, x2 = _pair(1, 1, 30, 44)
    jm = jcreate(NAME)
    with fast_inference(), jax.default_matmul_precision("float32"):
        want = jm.apply(variables, jnp.asarray(x1), jnp.asarray(x2),
                        train=False)
    got = _run(_port(variables), x1, x2)
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
        want = json.load(f)["UNFusion"]
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


def test_weight_carry_maxpool_mode():
    """maxpool mode has no down convs, in the JAX tree or the port."""
    cfg = dict(down_mode="maxpool", up_mode="nearest")
    sd = jax_to_state_dict(_variables(**cfg), NAME)
    assert sorted(sd) == sorted(create_model(NAME, **cfg).state_dict())
    assert not any("down" in k for k in sd)


@pytest.mark.parametrize("where", ["top", "block", "conv"])
def test_weight_carry_rejects_leftovers(variables, where):
    tree = jax.tree.map(np.copy, variables["params"])
    extra = {"kernel": np.zeros((3, 3, 1, 1), np.float32)}
    if where == "top":
        tree["conv9"] = extra
    elif where == "block":
        tree["decode"]["DB3_1"]["conv3"] = extra
    else:
        tree["encode"]["EB4_3"]["conv1"]["scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="unconverted"):
        jax_to_state_dict({"params": tree}, NAME)


@pytest.mark.parametrize("kw", [dict(fusion_mode="sum"),
                                dict(down_mode="avgpool"),
                                dict(up_mode="bicubic")])
def test_unknown_modes_raise(kw):
    with pytest.raises(ValueError):
        create_model(NAME, **kw)
