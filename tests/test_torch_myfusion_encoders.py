"""The port's MyFusion with its MetaFormer, MixConv and transformer
encoders, norm 'layer' and the hswish, silu and gelu activations (plain
path, CPU), against the JAX package's MyFusion (harness:
tests/test_torch_myfusion.py):

- JAX `model.apply` at 32x32: transformer_fs_elem and mixformer_ls_concat
  (the reference goldens' two configurations), conv_former and
  res2_former with the default frame, the encoder list [mix, sep, mix,
  sep] with three levels shared, and the default with act hswish, silu
  and gelu; transformer_fs_elem also at the odd 45x57 (the attention
  pools floor 45 -> 2 key rows at level 1);
- norm 'layer': conv_out's one-channel layer norm makes the fused image 0
  in both, so the decoder's output before conv_out is held instead;
- the reference PyTorch goldens of transformer_fs_elem and
  mixformer_ls_concat, state dicts loaded by their own names;
- the weight carry of every new encoder kind back through the JAX
  package's convert_state_dict, batch statistics included.

Weights: mf.seeded (the JAX variables tree from `jax.eval_shape`, filled
from a numpy seed); conv_former's seed-0 weights fuse a near-constant
image (std 2e-7) in the JAX package and the port alike, which would hold
nothing, so it takes seed 1. Each configuration's JAX model is built and
applied once (a module-scoped fixture). Tolerance 1e-4 (docs/PARITY.md,
model forwards).
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

import test_torch_myfusion as mf
import test_torch_nest_common as common
from conftest import nchw_to_nhwc, nhwc_to_nchw
from param_synth import synth_state_dict

from multi_modal_image_fusion_tpu.utils.torch_convert import \
    convert_state_dict
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

NAME = mf.NAME
ATOL = mf.ATOL
TRANSFORMER_FS_ELEM = dict(encoder="transformer", decoder="fs",
                           fusion_method="elem", fusion_mode="sum")
MIXFORMER_LS_CONCAT = dict(encoder="mix_former", decoder="ls",
                           fusion_method="concat", up_mode="nearest",
                           share_weight_levels=2)
# case: (configuration, weight seed)
CASES = {
    "transformer_fs_elem": (TRANSFORMER_FS_ELEM, 0),
    "mixformer_ls_concat": (MIXFORMER_LS_CONCAT, 0),
    "conv_former": (dict(encoder="conv_former"), 1),
    "res2_former": (dict(encoder="res2_former"), 0),
    "mix_sep_swl3": (dict(encoder=["mix", "sep", "mix", "sep"],
                          share_weight_levels=3), 0),
    "hswish": (dict(act="hswish"), 0),
    "silu": (dict(act="silu"), 0),
    "gelu": (dict(act="gelu"), 0),
}
LAYER_NORM = dict(norm="layer")


@pytest.fixture(scope="module")
def jax_run():
    """(JAX model, variables) of a configuration and its jitted apply on
    a seeded pair, each built once."""
    models, outs = {}, {}

    def run(cfg, seed, hw=(32, 32)):
        key = json.dumps(cfg, sort_keys=True) + str(seed)
        if key not in models:
            models[key] = mf.seeded(cfg, seed)
        okey = key + str(hw)
        if okey not in outs:
            jm, v = models[key]
            x1, x2 = common.pair(0, 2, *hw)
            outs[okey] = (x1, x2, mf.jax_apply(jm, v, x1, x2))
        return (*models[key], *outs[okey])
    return run


@pytest.mark.parametrize("case,hw", [(c, (32, 32)) for c in CASES]
                         + [("transformer_fs_elem", (45, 57))],
                         ids=list(CASES) + ["transformer_fs_elem-45x57"])
def test_vs_jax_apply(jax_run, case, hw):
    cfg, seed = CASES[case]
    _, v, x1, x2, want = jax_run(cfg, seed, hw)
    got = common.run(mf.port(v, **cfg), x1, x2)
    assert got.shape == (2, *hw, 1)
    assert want.std() > 1e-2 and (want > want.min()).mean() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_layer_norm_on_decoder_output():
    """norm 'layer' on conv_in, the TransitionBlocks and conv_out: the
    fused image is 0 in both (conv_out's layer norm over one channel), so
    the decoder's output is held against the JAX model's (one jitted
    apply returns both)."""
    jm, v = mf.seeded(LAYER_NORM)
    x1, x2 = common.pair(0, 2, 32, 32)
    model = mf.port(v, **LAYER_NORM)

    def decoded(m, a, b):
        f1, f2 = m.encoder_fn(a, b, False)
        y = m.decode(m.fusion(f1, f2, False), False)
        return y, m.conv_out(y, False)
    with jax.default_matmul_precision("float32"):
        want_dec, want = (np.asarray(t) for t in jax.jit(functools.partial(
            jm.apply, method=decoded))(v, x1, x2))
    assert np.abs(want).max() == 0.0
    assert np.abs(common.run(model, x1, x2)).max() == 0.0
    with torch.no_grad():
        got_dec = model.decode(model.fusion(model.encoder(
            torch.from_numpy(x1), torch.from_numpy(x2)))).numpy()
    assert want_dec.std() > 1e-2
    np.testing.assert_allclose(got_dec, want_dec, atol=ATOL)


@pytest.mark.parametrize("case", ["transformer_fs_elem",
                                  "mixformer_ls_concat"])
def test_vs_reference_goldens(golden, case):
    """The reference goldens (y at 64x64, y_odd at 52x44), state dicts
    loaded directly; their names and shapes are the port's."""
    d = golden(f"model_fwd_{NAME}_{case}")
    keyshapes = json.loads(bytes(d["keyshapes"]).decode())
    model = create_model(NAME, **CASES[case][0])
    assert {k: list(v.shape) for k, v in model.state_dict().items()} \
        == keyshapes
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synth_state_dict(keyshapes).items()})
    model.eval()
    for x1, x2, y in (("x1", "x2", "y"), ("x1o", "x2o", "y_odd")):
        got = common.run(model, nchw_to_nhwc(d[x1]), nchw_to_nhwc(d[x2]))
        np.testing.assert_allclose(nhwc_to_nchw(got), d[y], atol=ATOL)


@pytest.mark.parametrize("encoder", ["mix", "conv_former", "mix_former",
                                     "res2_former", "transformer"])
def test_weight_carry_round_trip(encoder):
    """JAX -> port -> the JAX package's convert_state_dict gives back every
    JAX leaf (the Formers' batch statistics too); the port's state dict
    has exactly the model's names. Two levels unshared, so both branches'
    blocks carry."""
    cfg = dict(encoder=encoder, share_weight_levels=2)
    _, variables = mf.seeded(cfg)
    model = create_model(NAME, **cfg)
    sd = jax_to_state_dict(variables, NAME, **model.layout_cfg)
    assert sorted(sd) == sorted(model.state_dict())
    back = convert_state_dict(
        NAME, {k: v.numpy() for k, v in sd.items()},
        **{k: model.layout_cfg[k] for k in ("encoder", "decoder",
                                            "fusion_method",
                                            "share_weight_levels")})
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))
