"""The port's IFCNN (plain path, CPU) against the JAX package (harness:
tests/test_torch_zoo_common.py), its batch norms seeded non-trivial:

- JAX `model.apply` (elementwise-max fusion) and autoencoder mode at 32x32
  and 45x61;
- the JAX H-major route (`_hiw_forward`: the norms folded into the convs)
  in the Pallas interpreter;
- the reference PyTorch goldens, the parameter count and state-dict
  shapes, the weight carry round trip (params and batch_stats) and its
  leftover rejection;
- the serving routes at the published widths, counted on the CPU as the
  card's launches: the k7 enter over both images, enc1 and dec0 on
  conv_chain, the k1 exit.
"""

import pytest
import torch

import test_torch_zoo_common as common
from multi_modal_image_fusion_tpu_torch.models import create_model

NAME = "ifcnn"
LAUNCHES = {"conv_gray_enter": 1, "conv_chain": 2, "conv_gray_exit": 1}


@pytest.mark.parametrize("hw", common.HWS)
@pytest.mark.parametrize("ae", [False, True], ids=["max", "ae"])
def test_vs_jax_apply(ae, hw):
    common.check_vs_apply(NAME, hw, ae)


def test_vs_jax_hiw_route(monkeypatch):
    common.check_fast_route(NAME, monkeypatch)


def test_vs_reference_goldens(golden):
    common.check_goldens(NAME, golden(f"model_fwd_{NAME}"))


def test_param_count_and_names():
    common.check_counts(NAME, "IFCNN")


def test_weight_carry_round_trip():
    common.check_round_trip(NAME, common.variables(NAME))


@pytest.mark.parametrize("where", ["top", "conv", "stats"])
def test_weight_carry_rejects_leftovers(where):
    common.check_rejects_leftovers(NAME, where)


def test_serving_routes(monkeypatch):
    model = common.random_norms(create_model(NAME), 1).eval()
    x1, x2 = torch.rand(1, 16, 24, 1), torch.rand(1, 16, 24, 1)
    assert common.kernel_calls(monkeypatch, model, x1, x2) == LAUNCHES
    assert common.kernel_calls(monkeypatch, model, x1) == LAUNCHES
