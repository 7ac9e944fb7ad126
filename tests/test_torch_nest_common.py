"""Shared harness of the port's NestFuse, RFNNest and MAFusion parity tests
(tests/test_torch_nestfuse.py, test_torch_rfnnest.py, test_torch_mafusion.py)
against the JAX package. It holds no test itself.

Weights are the JAX model's own init with seeded non-zero biases, made once
a configuration and carried over by utils/jax_convert.jax_to_state_dict; the
JAX side runs under jax.jit, one compile a shape (the fused and the
autoencoder outputs come from one compile). Tolerance 1e-4 (the
docs/PARITY.md model-forward budget; f32 on both sides). The JAX kernel
routes run in the Pallas interpreter (MMIF_CHAIN_INTERPRET=1 under
fast_inference) at narrowed widths (`num_ch`, a field of both packages'
models) and a small size: their compile takes most of a file's time.

`kernel_calls` counts, on CPU tensors, the serving kernels ConvLayer
reaches (the plain versions run, the routes are the card's): the counts a
forward launches on the card (chip_smoke.py FORWARD_LAUNCHES).
"""

import collections
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
from multi_modal_image_fusion_tpu_torch.ops import layers
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

ATOL = 1e-4
HWS = [(32, 32), (45, 61)]
FAST_HW = (16, 24)
# narrowed widths of the interpreted kernel routes: 8 mod 16 hidden widths
# at CB1_0 (8) and in the decoder, as at the published widths
NARROW = (16, 24, 40, 48)
KERNELS = ("conv_gray_enter", "conv_chain", "conv_multi", "conv_wide",
           "conv_gray_exit")


def pair(seed, b, h, w):
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


def _key(cfg):
    return tuple(sorted(cfg.items()))


@functools.lru_cache(maxsize=None)
def _variables(name, cfg_key):
    x = jnp.zeros((1, 32, 32, 1), jnp.float32)
    v = jax.jit(functools.partial(jcreate(name, **dict(cfg_key)).init,
                                  train=False))(jax.random.PRNGKey(0), x, x)
    params = jax.tree.map(np.array, v["params"])
    _with_bias(params, np.random.RandomState(100))
    return {"params": params}


def variables(name, **cfg):
    """The JAX init of a configuration with seeded non-zero biases, as
    nested numpy dicts (cached)."""
    return _variables(name, _key(cfg))


@functools.lru_cache(maxsize=None)
def _jax_outputs(name, hw, cfg_key):
    x1, x2 = pair(0, 2, *hw)
    jm = jcreate(name, **dict(cfg_key))

    def both(v, a, b):
        return (jm.apply(v, a, b, train=False), jm.apply(v, a, train=False))
    with jax.default_matmul_precision("float32"):
        y, y_ae = jax.jit(both)(_variables(name, cfg_key), jnp.asarray(x1),
                                jnp.asarray(x2))
    return np.asarray(y), np.asarray(y_ae)


def jax_outputs(name, hw, **cfg):
    """(fused, autoencoder) outputs of JAX `model.apply` on pair(0, 2, hw),
    one jit."""
    return _jax_outputs(name, hw, _key(cfg))


def port(name, variables, **cfg):
    model = create_model(name, **cfg)
    model.load_state_dict(jax_to_state_dict(variables, name))
    return model.eval()


def run(model, x1, x2=None):
    with torch.no_grad():
        y = model(torch.from_numpy(x1),
                  None if x2 is None else torch.from_numpy(x2))
    return y.numpy()


def check_vs_apply(name, hw, ae, **cfg):
    """The port against JAX `model.apply`, fused or autoencoder mode; the
    fused image is not constant (else the check would hold vacuously)."""
    x1, x2 = pair(0, 2, *hw)
    want = jax_outputs(name, hw, **cfg)[1 if ae else 0]
    got = run(port(name, variables(name, **cfg), **cfg), x1,
              None if ae else x2)
    assert got.shape == (2, *hw, 1)
    assert want.std() > 1e-3
    np.testing.assert_allclose(got, want, atol=ATOL)


def check_fast_route(name, monkeypatch):
    """The port against the JAX serving route in the Pallas interpreter
    (fast_inference, MMIF_CHAIN_INTERPRET=1) at NARROW widths."""
    monkeypatch.setenv("MMIF_CHAIN_INTERPRET", "1")
    cfg = dict(num_ch=NARROW)
    v = variables(name, **cfg)
    x1, x2 = pair(1, 1, *FAST_HW)
    with fast_inference(), jax.default_matmul_precision("float32"):
        want = np.asarray(jcreate(name, **cfg).apply(
            v, jnp.asarray(x1), jnp.asarray(x2), train=False))
    assert want.std() > 1e-3
    np.testing.assert_allclose(run(port(name, v, **cfg), x1, x2), want,
                               atol=ATOL)


def check_goldens(name, d):
    """The reference PyTorch goldens (y, y_odd, y_ae), state dicts loaded by
    their own names."""
    keyshapes = json.loads(bytes(d["keyshapes"]).decode())
    model = create_model(name)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synth_state_dict(keyshapes).items()})
    model.eval()
    x1, x2 = nchw_to_nhwc(d["x1"]), nchw_to_nhwc(d["x2"])
    np.testing.assert_allclose(nhwc_to_nchw(run(model, x1, x2)), d["y"],
                               atol=ATOL)
    np.testing.assert_allclose(
        nhwc_to_nchw(run(model, nchw_to_nhwc(d["x1o"]),
                         nchw_to_nhwc(d["x2o"]))), d["y_odd"], atol=ATOL)
    np.testing.assert_allclose(nhwc_to_nchw(run(model, x1)), d["y_ae"],
                               atol=ATOL)


def check_counts(name, ref_name):
    with open(os.path.join(GOLDEN_DIR, "param_counts.json")) as f:
        want = json.load(f)[ref_name]
    model = create_model(name)
    assert sum(p.numel() for p in model.parameters()) == want
    with open(os.path.join(GOLDEN_DIR, "sd_shapes.json")) as f:
        shapes = json.load(f)[name]
    assert {k: list(v.shape) for k, v in model.state_dict().items()} == shapes


def check_round_trip(name, variables, **cfg):
    """JAX -> port -> convert_state_dict gives back every JAX leaf."""
    sd = jax_to_state_dict(variables, name)
    assert sorted(sd) == sorted(create_model(name, **cfg).state_dict())
    back = convert_state_dict(name, {k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))


def check_rejects_leftovers(name, variables, where):
    tree = jax.tree.map(np.copy, variables["params"])
    extra = {"kernel": np.zeros((3, 3, 1, 1), np.float32)}
    if where == "top":
        tree["conv9"] = extra
    elif where == "block":
        tree["CB2_0"]["conv3"] = extra
    else:
        tree["decode"][sorted(tree["decode"])[0]]["conv1"]["scale"] = \
            np.ones(3, np.float32)
    with pytest.raises(ValueError, match="unconverted"):
        jax_to_state_dict({"params": tree}, name)


def kernel_calls(monkeypatch, model, x1, x2=None):
    """{kernel: calls} of one forward of `model` on CPU tensors: the
    serving kernels ConvLayer reached (their plain versions ran)."""
    seen = collections.Counter()
    for kname in KERNELS:
        real = getattr(layers, kname)

        def spy(*args, _real=real, _name=kname, **kw):
            seen[_name] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(layers, kname, spy)
    with torch.no_grad():
        y = model(x1, x2)
    assert torch.isfinite(y).all()
    return dict(seen)
