"""The port's PMGI (plain path, CPU) against the JAX package (harness:
tests/test_torch_zoo_common.py), its batch norms seeded non-trivial:

- JAX `model.apply` at 32x32 and 45x61 (no autoencoder mode, as in the JAX
  package);
- the JAX H-major route (`_hiw_forward`: the entry convs over concat(i, i,
  j) as two gray legs with summed weights, the cross-path concats as leg
  lists) in the Pallas interpreter;
- the reference PyTorch goldens, the parameter count and state-dict
  shapes (the dead transfer1[1] kept), the weight carry round trip (params
  and batch_stats) and its leftover rejection;
- the serving routes, counted on the CPU as the card's launches: two
  two-leg enters, two conv_chain, eight conv_multi, the exit over eight
  legs; transfer1[1] never runs and f1_conv2 is transfer2[1] of f1.
"""

import pytest
import torch

import test_torch_zoo_common as common
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import layers

NAME = "pmgi"
LAUNCHES = {"conv_gray_enter": 2, "conv_chain": 2, "conv_multi": 8,
            "conv_gray_exit": 1}


@pytest.mark.parametrize("hw", common.HWS)
def test_vs_jax_apply(hw):
    common.check_vs_apply(NAME, hw, False, has_ae=False)


def test_vs_jax_hiw_route(monkeypatch):
    common.check_fast_route(NAME, monkeypatch)


def test_vs_reference_goldens(golden):
    common.check_goldens(NAME, golden(f"model_fwd_{NAME}"))


def test_param_count_and_names():
    common.check_counts(NAME, "PMGI")


def test_weight_carry_round_trip():
    common.check_round_trip(NAME, common.variables(NAME))


@pytest.mark.parametrize("where", ["top", "conv", "stats"])
def test_weight_carry_rejects_leftovers(where):
    common.check_rejects_leftovers(NAME, where)


def test_serving_routes(monkeypatch):
    model = common.random_norms(create_model(NAME), 3).eval()
    x1, x2 = torch.rand(1, 16, 24, 1), torch.rand(1, 16, 24, 1)
    assert common.kernel_calls(monkeypatch, model, x1, x2) == LAUNCHES


def test_quirks_and_entry(monkeypatch):
    """transfer1[1] holds parameters and never runs; the entries read
    (img1, img2) and (img2, img1) as two legs with the repeated image's
    weights summed."""
    model = common.random_norms(create_model(NAME), 4).eval()
    ran = []
    for name, m in model.named_modules():
        if isinstance(m, layers.ConvLayer):
            m.register_forward_pre_hook(
                lambda mod, args, _n=name: ran.append(_n))
    calls = []
    real = layers.conv_gray_enter

    def spy(a, b, w, *args, **kw):
        calls.append((a, b, w))
        return real(a, b, w, *args, **kw)
    monkeypatch.setattr(layers, "conv_gray_enter", spy)
    x1, x2 = torch.rand(1, 12, 14, 1), torch.rand(1, 12, 14, 1)
    with torch.no_grad():
        model(x1, x2)
    assert "transfer1.1" not in ran and ran.count("transfer2.1") == 2
    assert [(a is x1, b is x2) for a, b, _ in calls] == [(True, True),
                                                          (False, False)]
    assert calls[1][0] is x2 and calls[1][1] is x1
    w, _ = model.gradient[0].folded()
    torch.testing.assert_close(calls[0][2][:, 0], w[:, 0] + w[:, 1])
    torch.testing.assert_close(calls[0][2][:, 1], w[:, 2])
    with pytest.raises(ValueError, match="no autoencoder mode"):
        model(x1)
