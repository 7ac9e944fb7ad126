"""The port's MyFusion (plain path, CPU) against the JAX package's MyFusion:

- JAX `model.apply` at 32x32 in seven configurations: the default (sep
  encoder, nest decoder, 'sca' attention fusion, stride downs, bilinear
  ups, every level shared), res2 + plain + rfn + maxpool with no level
  shared, sep + ls + concat + nearest with two levels shared, sep + fs +
  elem 'sum', the encoder list [sep, res2, sep, res2] with three levels
  shared, and the default with batch norms and with group norms; and the
  default at the odd 45x57 (VALID k2 downs floor 45 -> 22 -> 11 -> 5, the
  decoder's upsamples pad back);
- the JAX H-major route (`_hiw_forward`: MMIF_CHAIN_HIW_MULTI=1, its
  kernels in the Pallas interpreter) of the default configuration at
  narrowed widths;
- the reference PyTorch goldens of the default and res2_plain_rfn
  configurations, state dicts loaded by their own names. Their fused
  images are all zero (the synthetic weights drive conv_out's relu6
  below 0 at every pixel), so they hold names, shapes and the dead end;
  the JAX comparisons above hold the function.

Weights: the JAX model's variables tree, its shapes from `jax.eval_shape`
of its init (no init compile), filled from a numpy seed (`seeded`):
kernels Kaiming normal, conv_out's as |w| so that its relu6 output is
live, biases and norm shifts within +-0.1, norm scales in [0.5, 1.5],
batch norm variances in [0.5, 2]; carried by utils/jax_convert's
`myfusion` layout. Tolerance 1e-4 (docs/PARITY.md, model forwards).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_nest_common as common
from conftest import nchw_to_nhwc, nhwc_to_nchw
from param_synth import synth_state_dict

from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.ops.layers import fast_inference
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

NAME = "myfusion"
ATOL = 1e-4
RES2_PLAIN_RFN = dict(encoder="res2", decoder="plain", fusion_method="rfn",
                      down_mode="maxpool", share_weight_levels=0)
CASES = {
    "default": {},
    "res2_plain_rfn": RES2_PLAIN_RFN,
    "sep_ls_concat": dict(decoder="ls", fusion_method="concat",
                          up_mode="nearest", share_weight_levels=2),
    "sep_fs_elem": dict(decoder="fs", fusion_method="elem",
                        fusion_mode="sum"),
    "mixed_swl3": dict(encoder=["sep", "res2", "sep", "res2"],
                       share_weight_levels=3),
    "batch": dict(norm="batch"),
    "group": dict(norm="group"),
}
# narrowed widths of the interpreted H-major route
NARROW = (8, 16, 24, 32)


def seeded_tree(shapes, seed, live=()):
    """A JAX variables tree of `shapes` (ShapeDtypeStructs) filled from
    numpy seed `seed`; kernels under a top-level module in `live` are |w|."""
    r = np.random.RandomState(seed)

    def fill(path, s):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            w = r.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
            if keys[1] in live:
                w = np.abs(w)
        elif keys[-1] == "var":
            w = 0.5 + 1.5 * r.rand(*s.shape)
        elif keys[-1] == "scale":
            w = 0.5 + r.rand(*s.shape)
        else:           # biases, norm shifts, batch norm means
            w = 0.2 * (r.rand(*s.shape) - 0.5)
        return w.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def seeded(cfg, seed=0):
    """(JAX model, its params and batch statistics from `seeded_tree`) of
    a configuration (the init's other collections, a Res2 block's int8
    calibration slots, are left out)."""
    jm = jcreate(NAME, **cfg)
    x = jax.ShapeDtypeStruct((1, 32, 32, 1), jnp.float32)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.PRNGKey(0), x, x)
    shapes = {k: shapes[k] for k in ("params", "batch_stats") if k in shapes}
    return jm, seeded_tree(shapes, seed, live=("conv_out",))


def port(variables, **cfg):
    model = create_model(NAME, **cfg)
    model.load_state_dict(jax_to_state_dict(variables, NAME,
                                            **model.layout_cfg))
    return model.eval()


def jax_apply(jm, variables, x1, x2, x64=False):
    """JAX `model.apply`, jitted; x64: in float64 (params and inputs)."""
    fn = jax.jit(functools.partial(jm.apply, train=False))
    if not x64:
        with jax.default_matmul_precision("float32"):
            return np.asarray(fn(variables, x1, x2))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        return np.asarray(fn(v64, x1.astype(np.float64),
                             x2.astype(np.float64)))


@pytest.mark.parametrize("case,hw", [(c, (32, 32)) for c in CASES]
                         + [("default", (45, 57))],
                         ids=list(CASES) + ["default-45x57"])
def test_vs_jax_apply(case, hw):
    """The port against JAX `model.apply`; the fused image is live. The
    group-norm case holds the port against JAX in float64: flax's
    GroupNorm takes its f32 variance as E[x^2] - E[x]^2 (use_fast_variance)
    and its f32 forward lies 2.3e-4 from the float64 one here, the port's
    f32 (ops/layers.group_norm, centred first) 3.8e-5."""
    cfg = CASES[case]
    jm, v = seeded(cfg)
    x1, x2 = common.pair(0, 2, *hw)
    want = jax_apply(jm, v, x1, x2, x64=cfg.get("norm") == "group")
    got = common.run(port(v, **cfg), x1, x2)
    assert got.shape == (2, *hw, 1)
    assert want.std() > 1e-2 and (want > want.min()).mean() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_vs_jax_hiw_route(monkeypatch):
    """The port against the JAX package's H-major route of the default
    configuration (MyFusion is in HIW_MULTI_BLOCKLIST: forced with
    MMIF_CHAIN_HIW_MULTI=1; fast_inference, MMIF_CHAIN_INTERPRET=1) at
    NARROW widths: the strided downs as weighted stride-pools, the dw
    convs as banded dots, the fusion and decoder on H-major kernels."""
    monkeypatch.setenv("MMIF_CHAIN_INTERPRET", "1")
    monkeypatch.setenv("MMIF_CHAIN_HIW_MULTI", "1")
    cfg = dict(num_ch=NARROW)
    jm, v = seeded(cfg)
    x1, x2 = common.pair(1, 1, *common.FAST_HW)
    with fast_inference(), jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
            v, jnp.asarray(x1), jnp.asarray(x2)))
    assert want.std() > 1e-2
    np.testing.assert_allclose(common.run(port(v, **cfg), x1, x2), want,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["default", "res2_plain_rfn"])
def test_vs_reference_goldens(golden, case):
    """The reference goldens (y at 64x64, y_odd at 52x44), state dicts
    loaded directly; their names and shapes are the port's."""
    d = golden(f"model_fwd_{NAME}_{case}")
    keyshapes = json.loads(bytes(d["keyshapes"]).decode())
    model = create_model(NAME, **CASES[case])
    assert {k: list(v.shape) for k, v in model.state_dict().items()} \
        == keyshapes
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synth_state_dict(keyshapes).items()})
    model.eval()
    for x1, x2, y in (("x1", "x2", "y"), ("x1o", "x2o", "y_odd")):
        got = common.run(model, nchw_to_nhwc(d[x1]), nchw_to_nhwc(d[x2]))
        np.testing.assert_allclose(nhwc_to_nchw(got), d[y], atol=ATOL)


def test_param_count():
    with open(os.path.join(common.GOLDEN_DIR, "param_counts.json")) as f:
        want = json.load(f)["MyFusion"]
    assert sum(p.numel() for p in create_model(NAME).parameters()) == want
