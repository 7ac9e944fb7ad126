"""One train step of VIFNet, DBNet, UNFusion, PFNetv1 and PFNetv2 through
the port's Trainer against the JAX step's gradients and loss parts
(harness: tests/test_torch_step_common.py), plain and with `fast=True`
(every model here has dense k3 convs: conv_valid_fast's plain versions on
the CPU). No batch norm: the optimizer after the gradients is the one
tests/test_torch_train.py holds.

Weight draws (`SEEDS`): a draw whose f32 gradients are well-conditioned,
the port's own f32 gradients within 1e-5 of the largest from its float64
ones (4.3e-6 PFNetv1 seed 2, 6.0e-5 UNFusion seed 1, the best of seeds
0-3, whose 2 and 3 fuse a constant image; the others <1e-6 at seed 0).
At PFNetv1's seed 0 they lie 3.8e-3 from float64, at UNFusion's 1.4e-3: a
parity test of f32 gradients at 1e-4 decides nothing there."""

import pytest

import test_torch_step_common as sc

MODELS = ("vifnet", "dbnet", "unfusion", "pfnetv1", "pfnetv2")
SEEDS = {"pfnetv1": 2, "unfusion": 1}


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_step_matches_jax(name, fast):
    sc.check_step(name, fast, seed=SEEDS.get(name, 0))
