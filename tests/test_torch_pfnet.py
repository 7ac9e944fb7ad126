"""The port's PFNetv1 and PFNetv2 (plain path, CPU) against the JAX package
(harness: tests/test_torch_zoo_common.py):

- JAX `model.apply` at 32x32 and 45x61, fused and (PFNetv2) autoencoder
  mode;
- the JAX H-major routes in the Pallas interpreter: PFNetv1's 8-leg
  decode0 over both unshared encoders' legs, PFNetv2's block-diagonal fuse
  net (`hiw_group_weights`);
- the reference PyTorch goldens, the parameter counts and state-dict
  shapes, the weight carry round trip and its leftover rejection;
- the serving routes at the published widths, counted on the CPU as the
  card's launches.
"""

import pytest
import torch

import test_torch_zoo_common as common
from multi_modal_image_fusion_tpu_torch.models import create_model

NAMES = {"pfnetv1": "PFNetv1", "pfnetv2": "PFNetv2"}
LAUNCHES = {
    # two encoders (1 enter + 3 conv_multi each), the 8-leg decode0,
    # decode1-3 conv_chain, decode4 exit
    "pfnetv1": {"conv_gray_enter": 2, "conv_multi": 7, "conv_chain": 3,
                "conv_gray_exit": 1},
    # dense growth 3 conv_multi, fuse0 (8 legs) conv_multi, fuse1, fuse2
    # and decode0-2 conv_chain, decode3 exit
    "pfnetv2": {"conv_gray_enter": 1, "conv_multi": 4, "conv_chain": 5,
                "conv_gray_exit": 1},
}
PFNETV2_AE = {"conv_gray_enter": 1, "conv_multi": 4, "conv_chain": 2,
              "conv_gray_exit": 1}


@pytest.mark.parametrize("hw", common.HWS)
@pytest.mark.parametrize("case", ["pfnetv1", "pfnetv2", "pfnetv2-ae"])
def test_vs_jax_apply(case, hw):
    name = case.split("-")[0]
    common.check_vs_apply(name, hw, case.endswith("ae"),
                          has_ae=name == "pfnetv2")


@pytest.mark.parametrize("name", sorted(NAMES))
def test_vs_jax_hiw_route(name, monkeypatch):
    common.check_fast_route(name, monkeypatch)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_vs_reference_goldens(name, golden):
    common.check_goldens(name, golden(f"model_fwd_{name}"))


@pytest.mark.parametrize("name", sorted(NAMES))
def test_param_count_and_names(name):
    common.check_counts(name, NAMES[name])


@pytest.mark.parametrize("name", sorted(NAMES))
def test_weight_carry_round_trip(name):
    common.check_round_trip(name, common.variables(name))


@pytest.mark.parametrize("where", ["top", "conv", "stats"])
@pytest.mark.parametrize("name", sorted(NAMES))
def test_weight_carry_rejects_leftovers(name, where):
    common.check_rejects_leftovers(name, where)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_serving_routes(name, monkeypatch):
    model = create_model(name).eval()
    x1, x2 = torch.rand(2, 16, 24, 1), torch.rand(2, 16, 24, 1)
    assert common.kernel_calls(monkeypatch, model, x1, x2) == LAUNCHES[name]
    if name == "pfnetv2":
        assert common.kernel_calls(monkeypatch, model, x1) == PFNETV2_AE
