"""MyFusion's blocks, weight carry and serving routes in the port, against
the JAX package (harness: tests/test_torch_myfusion.py):

- TransitionBlock in both down modes (a VALID k2 stride-2 depthwise conv
  at an odd size, the k1 stride-1 one, the 2x2 max pool), SepConvBlock
  with and without the attention gate and its identity or k1 shortcut,
  DCBlock over the legs of its input with and without its residual (an
  identity or a k1 shortcut), each against the JAX block's `apply` on the
  same seeded weights at 2e-5 (docs/PARITY.md, blocks);
- the `myfusion` weight carry: every leaf back through the JAX package's
  convert_state_dict at share_weight_levels 4, 2 and 0, leftovers
  rejected;
- the serving routes at the default widths, counted on the CPU as the
  card's launches (chip_smoke.py FORWARD_LAUNCHES), and the layers that
  take conv_wide;
- the configurations still to port raise NotImplementedError naming
  ROADMAP.md queue 1 item 4b; ConvLayer refuses a VALID or even-kernel
  layer outside TransitionBlock's case.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_myfusion as mf
from multi_modal_image_fusion_tpu.ops import blocks as jblocks
from multi_modal_image_fusion_tpu.utils.torch_convert import \
    convert_state_dict
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import blocks, layers
from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

BLOCK_ATOL = 2e-5
NAME = mf.NAME
KERNELS = ("conv_gray_enter", "conv_chain", "conv_multi", "conv_wide",
           "conv_dw", "conv_gray_exit")
# one fused forward (chip_smoke.py FORWARD_LAUNCHES): the default config's
# conv_chain: 4 TransitionBlock pw, 4 SepConvBlock pwconv1, 6 DCBlock pw2;
# conv_dw: down1's k1, 4 SepConvBlock dw, 6 DCBlock dw; conv_multi: 4
# pwconv2 with the identity shortcut, the pw1 of DB2_1, DB3_1, DB1_2 and
# DB2_2 over their legs; conv_wide: DB1_1's and DB1_3's pw1 (24 and 40)
LAUNCHES = {
    "default": {"conv_gray_enter": 1, "conv_chain": 14, "conv_dw": 11,
                "conv_multi": 8, "conv_wide": 2, "conv_gray_exit": 1},
    # each branch: conv_in, down1's k1 dw, 4 pw, 4 Res2 blocks (pwconv1,
    # 4 dw, pwconv2 over 4 legs); 4 RFNs (res and fuse1 on conv_multi);
    # the plain decoder's 3 DCBlocks on one tensor each
    "res2_plain_rfn": {"conv_gray_enter": 2, "conv_chain": 38,
                       "conv_dw": 37, "conv_multi": 16, "conv_gray_exit": 1},
}


def _seeded_block(jblock, *inputs, seed=3):
    shapes = jax.eval_shape(functools.partial(jblock.init, train=False),
                            jax.random.PRNGKey(0), *inputs)
    return mf.seeded_tree(shapes, seed)


def _carry(params, names):
    """Flax {name: {kernel, bias?}} of one block -> the port block's state
    dict: names maps each flax conv to its port prefix."""
    sd = {}
    for flax_name, prefix in names.items():
        if flax_name not in params:
            continue
        leaf = params[flax_name]
        sd[f"{prefix}.layers.0.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(leaf["kernel"], (3, 2, 0, 1))))
        if "bias" in leaf:
            sd[f"{prefix}.layers.0.bias"] = torch.from_numpy(leaf["bias"])
    return sd


def _rand(seed, shape, lo=0.0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32) + lo


def _check(jblock, jinput, port_block, port_input, names):
    v = _seeded_block(jblock, jinput)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jblock.apply(v, jnp.asarray(jinput), train=False))
    port_block.load_state_dict(_carry(v["params"], names))
    with torch.no_grad():
        got = port_block.eval()(port_input).numpy()
    assert want.std() > 1e-2
    np.testing.assert_allclose(got, want, atol=BLOCK_ATOL)


@pytest.mark.parametrize("mode,stride,hw", [("stride", 2, (45, 57)),
                                            ("stride", 1, (20, 24)),
                                            ("maxpool", 2, (45, 57))])
def test_transition_block(mode, stride, hw):
    cin = 8 if stride == 1 else 16
    x = _rand(10, (2, *hw, cin))
    _check(jblocks.TransitionBlock(32, stride=stride, down_mode=mode), x,
           blocks.TransitionBlock(cin, 32, stride, mode),
           torch.from_numpy(x), {"dw": "layers.0", "pw": "layers.1"})


@pytest.mark.parametrize("attention", [False, True],
                         ids=["plain", "attention"])
@pytest.mark.parametrize("cout", [16, 32], ids=["identity", "shortcut"])
def test_sep_conv_block(attention, cout):
    x = _rand(11, (2, 20, 24, 16))
    names = {n: n for n in ("pwconv1", "dwconv", "pwconv2", "shortcut",
                            "pwconv")}
    _check(jblocks.SepConvBlock(cout, attention=attention), x,
           blocks.SepConvBlock(16, cout, attention=attention),
           torch.from_numpy(x), names)


@pytest.mark.parametrize("residual,legs,cout", [
    (False, (16, 32), 16), (True, (16, 32), 16), (True, (16, 16), 32)],
    ids=["plain", "residual-shortcut", "residual-identity"])
def test_dc_block(residual, legs, cout):
    """Over the legs of its input (never concatenated on the serving
    route), against the JAX block on the concat; hidden width 24 (the
    conv_wide case) in the first two."""
    xs = [_rand(12 + i, (2, 20, 24, c)) for i, c in enumerate(legs)]
    names = {"pw1": "layers.0", "dw": "layers.1", "pw2": "layers.2",
             "shortcut": "shortcut"}
    _check(jblocks.DCBlock(cout, residual=residual), np.concatenate(xs, -1),
           blocks.DCBlock(sum(legs), cout, residual=residual),
           [(torch.from_numpy(x), 0) for x in xs], names)


CARRY_CASES = {4: {}, 2: mf.CASES["sep_ls_concat"], 0: mf.RES2_PLAIN_RFN}


@pytest.mark.parametrize("swl", sorted(CARRY_CASES))
def test_weight_carry_round_trip(swl):
    """JAX -> port -> the JAX package's convert_state_dict gives back every
    JAX leaf; the port's state dict has exactly the model's names."""
    cfg = CARRY_CASES[swl]
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


@pytest.mark.parametrize("where", ["top", "block", "decoder", "stats"])
def test_weight_carry_rejects_leftovers(where):
    cfg = mf.CASES["batch"]
    _, variables = mf.seeded(cfg)
    tree = jax.tree.map(np.copy, variables)
    extra = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    if where == "top":
        tree["params"]["conv9"] = extra
    elif where == "block":
        tree["params"]["EB2_1"]["pwconv"] = extra
    elif where == "decoder":
        tree["params"]["decode"]["DB1_1"]["shortcut"] = extra
    else:
        tree["batch_stats"]["conv_out"]["norm"]["extra"] = np.zeros(1)
    with pytest.raises(ValueError, match="unconverted"):
        jax_to_state_dict(tree, NAME, **create_model(NAME, **cfg).layout_cfg)


def kernel_calls(monkeypatch, model, x1, x2):
    """{kernel: calls} of one forward on CPU tensors: the serving kernels
    ConvLayer reached (their plain versions ran)."""
    seen = collections.Counter()
    for kname in KERNELS:
        real = getattr(layers, kname)

        def spy(*args, _real=real, _name=kname, **kw):
            seen[_name] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(layers, kname, spy)
    with torch.no_grad():
        assert torch.isfinite(model(x1, x2)).all()
    return dict(seen)


@pytest.mark.parametrize("case", sorted(LAUNCHES))
def test_serving_routes(monkeypatch, case):
    """At the default widths: every conv on its kernel (the counts a
    forward launches on the card); conv_wide for the DCBlocks' pw1 of a
    hidden width 8 mod 16; the stride-2 downs VALID depthwise layers
    (F.conv2d on every route), the level-1 down a k1 conv_dw."""
    model = create_model(NAME, **mf.CASES[case]).eval()
    x1, x2 = torch.rand(1, 33, 41, 1), torch.rand(1, 33, 41, 1)
    assert kernel_calls(monkeypatch, model, x1, x2) == LAUNCHES[case]
    wide = sorted(n for n, m in model.named_modules()
                  if getattr(m, "wide", False))
    assert wide == ([] if case != "default" else
                    ["decode.DB1_1.layers.0", "decode.DB1_3.layers.0"])
    if case == "default":
        strided = sorted(n for n, m in model.named_modules()
                         if isinstance(m, ConvLayer) and m.stride == 2)
        assert strided == [f"down{i}_1.layers.0" for i in (2, 3, 4)]
        assert all(model.get_submodule(s).groups == model.get_submodule(
            s).in_ch and model.get_submodule(s).padding == 0
            for s in strided)


@pytest.mark.parametrize("kw", [dict(encoder="transformer"),
                                dict(encoder=["sep", "mix_former", "sep",
                                              "sep"]),
                                dict(norm="layer"), dict(act="gelu"),
                                dict(act="hswish")],
                         ids=["transformer", "mix_former", "layer", "gelu",
                              "hswish"])
def test_unported_configs_raise(kw):
    with pytest.raises(NotImplementedError, match="queue 1 item 4b"):
        create_model(NAME, **kw)


@pytest.mark.parametrize("kw", [dict(ksize=2),
                                dict(ksize=2, stride=2, padding=0),
                                dict(ksize=3, stride=2, groups=16),
                                dict(ksize=3, stride=3, padding=0,
                                     groups=16)],
                         ids=["even-same", "valid-dense", "dw-stride-same",
                              "valid-stride3"])
def test_conv_layer_refuses(kw):
    """Only TransitionBlock's VALID depthwise layer (ksize == stride, 1 or
    2) takes padding 0 or an even kernel."""
    with pytest.raises(ValueError):
        ConvLayer(16, 16, **kw)
