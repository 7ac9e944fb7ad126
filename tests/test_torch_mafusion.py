"""The port's MAFusion (plain path, CPU) against the JAX package
(harness: tests/test_torch_nest_common.py):

- JAX `model.apply` in 'sca' fusion (maxpool, bilinear) and autoencoder
  mode at 32x32 and 45x61, whose U-Net3+ legs repair odd sizes after max
  pools x4 and x2 and bilinear upsamples x2, x4 and x8;
- the JAX C-major chain route (MAFusion is in HIW_MULTI_BLOCKLIST:
  conv_tlane_chain for every ConvBlock conv, summed per-part convs over
  the decoder's four legs) in the Pallas interpreter at narrowed widths;
- the reference PyTorch goldens, the parameter count and state-dict
  shapes, the weight carry round trip;
- the serving routes at the published widths, counted on the CPU as the
  card's launches: every ConvBlock conv on conv_wide.
"""

import pytest
import torch

import test_torch_nest_common as common
from multi_modal_image_fusion_tpu_torch.models import create_model

NAME = "mafusion"
LAUNCHES = {"conv_gray_enter": 1, "conv_wide": 14, "conv_gray_exit": 1}


@pytest.mark.parametrize("hw", common.HWS)
@pytest.mark.parametrize("ae", [False, True], ids=["sca", "ae"])
def test_vs_jax_apply(ae, hw):
    common.check_vs_apply(NAME, hw, ae)


def test_vs_jax_chain_route(monkeypatch):
    common.check_fast_route(NAME, monkeypatch)


def test_vs_reference_goldens(golden):
    common.check_goldens(NAME, golden(f"model_fwd_{NAME}"))


def test_param_count_and_names():
    common.check_counts(NAME, "MAFusion")


def test_weight_carry_round_trip():
    common.check_round_trip(NAME, common.variables(NAME))


@pytest.mark.parametrize("where", ["top", "block", "conv"])
def test_weight_carry_rejects_leftovers(where):
    common.check_rejects_leftovers(NAME, common.variables(NAME), where)


def test_serving_routes(monkeypatch):
    model = create_model(NAME).eval()
    x1, x2 = torch.rand(1, 16, 24, 1), torch.rand(1, 16, 24, 1)
    assert common.kernel_calls(monkeypatch, model, x1, x2) == LAUNCHES
    assert common.kernel_calls(monkeypatch, model, x1) == LAUNCHES
    assert all(m.wide for n, m in model.named_modules()
               if n.startswith(("CB", "decode.")) and hasattr(m, "wide"))
