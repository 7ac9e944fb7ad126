"""Shared harness of the port's PFNetv1, PFNetv2, IFCNN, DIFNet and PMGI
parity tests (tests/test_torch_{pfnet,ifcnn,difnet,pmgi}.py) against the
JAX package. It holds no test itself.

Weights are the JAX model's own init at 32x32 with seeded values where the
init is trivial: conv biases within +-0.05, and every batch norm's scale in
[0.5, 1.5], bias and running mean within +-0.1 and running variance in
[0.5, 2], so a fold left out, or one of its terms, shows. They are made
once a model and carried over by utils/jax_convert.jax_to_state_dict
(params and batch_stats). The JAX side runs `model.apply(train=False)`
under jax.jit, one compile a shape; its H-major route in the Pallas
interpreter (MMIF_CHAIN_INTERPRET=1 under fast_inference) at a small size.
Tolerance 1e-4 (the docs/PARITY.md model-forward budget; f32 on both
sides). Parameter counts, state-dict shapes, the weight carry's round trip
and the serving routes' kernel counts come from
tests/test_torch_nest_common.py.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import nchw_to_nhwc, nhwc_to_nchw
from param_synth import synth_state_dict
from test_torch_nest_common import (ATOL, check_counts,  # noqa: F401
                                    check_round_trip, kernel_calls, pair,
                                    run)

from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.ops.layers import fast_inference
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

HWS = [(32, 32), (45, 61)]
FAST_HW = (16, 24)


def _seeded(tree, r, stats=False):
    """Seeded non-trivial conv biases and norm params (stats=False) or
    batch statistics (stats=True), in place."""
    def uniform(lo, hi, like):
        return r.uniform(lo, hi, like.shape).astype(np.float32)
    for key, leaf in tree.items():
        if not hasattr(leaf, "items"):
            continue
        if key == "norm" and stats:
            leaf["mean"] = uniform(-0.1, 0.1, leaf["mean"])
            leaf["var"] = uniform(0.5, 2.0, leaf["var"])
        elif key == "norm":
            leaf["scale"] = uniform(0.5, 1.5, leaf["scale"])
            leaf["bias"] = uniform(-0.1, 0.1, leaf["bias"])
        else:
            if "kernel" in leaf and "bias" in leaf and not stats:
                leaf["bias"] = uniform(-0.05, 0.05, leaf["bias"])
            _seeded(leaf, r, stats)


@functools.lru_cache(maxsize=None)
def variables(name):
    """The JAX init of `name` with seeded biases and batch norms, as
    nested numpy dicts {"params", ["batch_stats"]} (cached)."""
    x = jnp.zeros((1, 32, 32, 1), jnp.float32)
    v = jax.jit(functools.partial(jcreate(name).init, train=False))(
        jax.random.PRNGKey(0), x, x)
    out = {k: jax.tree.map(np.array, v[k]) for k in ("params", "batch_stats")
           if k in v}
    r = np.random.RandomState(100)
    _seeded(out["params"], r)
    if "batch_stats" in out:
        _seeded(out["batch_stats"], r, stats=True)
    return out


@functools.lru_cache(maxsize=None)
def jax_outputs(name, hw, ae):
    """(fused, autoencoder or None) outputs of JAX `model.apply` on
    pair(0, 2, hw), one jit."""
    x1, x2 = pair(0, 2, *hw)
    jm = jcreate(name)

    def both(v, a, b):
        return (jm.apply(v, a, b, train=False),
                jm.apply(v, a, train=False) if ae else None)
    with jax.default_matmul_precision("float32"):
        y, y_ae = jax.jit(both)(variables(name), jnp.asarray(x1),
                                jnp.asarray(x2))
    return np.asarray(y), None if y_ae is None else np.asarray(y_ae)


def port(name, v=None):
    model = create_model(name)
    model.load_state_dict(jax_to_state_dict(v or variables(name), name))
    return model.eval()


def check_vs_apply(name, hw, ae, has_ae=True):
    """The port against JAX `model.apply`, fused or autoencoder mode; the
    fused image is not constant (else the check would hold vacuously)."""
    x1, x2 = pair(0, 2, *hw)
    want = jax_outputs(name, hw, has_ae)[1 if ae else 0]
    got = run(port(name), x1, None if ae else x2)
    assert got.shape == (2, *hw, 1)
    assert want.std() > 1e-3
    np.testing.assert_allclose(got, want, atol=ATOL)


def check_fast_route(name, monkeypatch, hw=FAST_HW):
    """The port against the JAX H-major route (`_hiw_forward`) in the
    Pallas interpreter (fast_inference, MMIF_CHAIN_INTERPRET=1)."""
    monkeypatch.setenv("MMIF_CHAIN_INTERPRET", "1")
    v = variables(name)
    x1, x2 = pair(1, 1, *hw)
    with fast_inference(), jax.default_matmul_precision("float32"):
        want = np.asarray(jcreate(name).apply(
            v, jnp.asarray(x1), jnp.asarray(x2), train=False))
    assert want.std() > 1e-3
    np.testing.assert_allclose(run(port(name, v), x1, x2), want, atol=ATOL)


def check_goldens(name, d):
    """The reference PyTorch goldens (y, y_odd and, where the model has an
    autoencoder mode, y_ae), state dicts loaded by their own names."""
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
    if "y_ae" in d.files:
        np.testing.assert_allclose(nhwc_to_nchw(run(model, x1)), d["y_ae"],
                                   atol=ATOL)
    else:
        with pytest.raises(ValueError, match="no autoencoder mode"):
            run(model, x1)


def check_rejects_leftovers(name, where):
    """The weight carry fails loudly on a JAX leaf it leaves unused: a top
    level param, a leaf under a conv, a batch_stats leaf."""
    v = jax.tree.map(np.copy, variables(name))
    if where == "top":
        v["params"]["conv9"] = {"kernel": np.zeros((3, 3, 1, 1), np.float32)}
    elif where == "conv":
        leaf = v["params"][sorted(v["params"])[0]]
        leaf = leaf if "kernel" in leaf else leaf[sorted(leaf)[0]]
        leaf["scale"] = np.ones(3, np.float32)
    else:
        v.setdefault("batch_stats", {})["extra"] = {
            "norm": {"mean": np.zeros(3, np.float32),
                     "var": np.ones(3, np.float32)}}
    with pytest.raises(ValueError, match="unconverted"):
        jax_to_state_dict(v, name)


def random_norms(model, seed):
    """Seeded non-trivial batch norms (scale, bias, statistics) on a port
    model, in place; returns the model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.bias.copy_(0.2 * torch.rand(n, generator=g) - 0.1)
                m.running_mean.copy_(0.2 * torch.rand(n, generator=g) - 0.1)
                m.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=g))
    return model
