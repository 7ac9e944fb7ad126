"""The port's NestFuse (plain path, CPU) against the JAX package
(harness: tests/test_torch_nest_common.py):

- JAX `model.apply` in 'sca' fusion (the default: maxpool, nearest) and
  autoencoder mode at 32x32 and the odd 45x61 (whose 2x2 pools drop the odd
  rows and columns and whose x2 upsamples pad back), and in stride mode
  (down1-down3, F.conv2d) at 45x61;
- the JAX H-major multi-leg route (`_hiw_forward`: conv_hiw_chain and
  conv_hiw_chain_multi in the Pallas interpreter) at narrowed widths;
- the reference PyTorch goldens, the parameter count and state-dict
  shapes, the weight carry round trip in both down modes;
- the serving routes at the published widths: which kernel each conv
  reaches (conv_wide where the output width is 8 mod 16), counted on the
  CPU as the card's launches; and that UNFusion's nested decoder, built
  through the same NestDecoder, keeps its DCB blocks, names and routes.
"""

import pytest
import torch

import test_torch_nest_common as common
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops.blocks import DCB, ConvBlock

NAME = "nestfuse"
# one fused forward (chip_smoke.py FORWARD_LAUNCHES)
LAUNCHES = {"conv_gray_enter": 1, "conv_chain": 12, "conv_wide": 7,
            "conv_multi": 1, "conv_gray_exit": 1}


@pytest.mark.parametrize("hw", common.HWS)
@pytest.mark.parametrize("ae", [False, True], ids=["sca", "ae"])
def test_vs_jax_apply(ae, hw):
    common.check_vs_apply(NAME, hw, ae)


def test_vs_jax_apply_stride_mode():
    common.check_vs_apply(NAME, (45, 61), False, down_mode="stride")


def test_vs_jax_hiw_route(monkeypatch):
    common.check_fast_route(NAME, monkeypatch)


def test_vs_reference_goldens(golden):
    common.check_goldens(NAME, golden(f"model_fwd_{NAME}"))


def test_param_count_and_names():
    common.check_counts(NAME, "NestFuse")


@pytest.mark.parametrize("cfg", [{}, dict(down_mode="stride")],
                         ids=["maxpool", "stride"])
def test_weight_carry_round_trip(cfg):
    common.check_round_trip(NAME, common.variables(NAME, **cfg), **cfg)
    has_downs = any(k.startswith("down") for k in
                    create_model(NAME, **cfg).state_dict())
    assert has_downs == ("down_mode" in cfg)


@pytest.mark.parametrize("where", ["top", "block", "conv"])
def test_weight_carry_rejects_leftovers(where):
    common.check_rejects_leftovers(NAME, common.variables(NAME), where)


def test_serving_routes(monkeypatch):
    """At the published widths: one enter, conv_wide for CB1_0 and CB3_0's
    conv1 (8 and 56 channels) and the first conv of five decoder blocks,
    conv_multi for DB2_2's (192), conv_chain for every other conv, one
    exit; the autoencoder runs the same convs."""
    model = create_model(NAME).eval()
    x1, x2 = torch.rand(1, 16, 24, 1), torch.rand(1, 16, 24, 1)
    assert common.kernel_calls(monkeypatch, model, x1, x2) == LAUNCHES
    assert common.kernel_calls(monkeypatch, model, x1) == LAUNCHES
    wide = sorted(n for n, m in model.named_modules()
                  if getattr(m, "wide", False))
    assert wide == ["CB1_0.layers.0", "CB3_0.layers.0"] + [
        f"decode.{b}.layers.0"
        for b in ("DB1_1", "DB1_2", "DB1_3", "DB2_1", "DB3_1")]
    assert all(type(model.decode.get_submodule(b)) is ConvBlock
               for b in ("DB1_1", "DB2_2", "DB1_3"))


def test_unfusion_decoder_unchanged(monkeypatch):
    """UNFusion builds its decoder through the same NestDecoder with DCB
    blocks: the same block types, state-dict names and shapes, and 18
    conv_wide launches a forward (12 of them the decoder's)."""
    model = create_model("unfusion").eval()
    assert all(type(model.decode.get_submodule(b)) is DCB
               for b in ("DB1_1", "DB2_1", "DB3_1", "DB1_2", "DB2_2",
                         "DB1_3"))
    common.check_counts("unfusion", "UNFusion")
    x1, x2 = torch.rand(1, 16, 24, 1), torch.rand(1, 16, 24, 1)
    assert common.kernel_calls(monkeypatch, model, x1, x2) == {
        "conv_gray_enter": 1, "conv_chain": 9, "conv_wide": 18,
        "conv_gray_exit": 1}
    assert sum(getattr(m, "wide", False) for m in model.decode.modules()) \
        == 12


@pytest.mark.parametrize("kw", [dict(fusion_mode="l1"),
                                dict(down_mode="avgpool"),
                                dict(up_mode="bicubic")])
def test_unknown_modes_raise(kw):
    with pytest.raises(ValueError):
        create_model(NAME, **kw)
