"""One train step of NestFuse, RFNNest and MAFusion through the port's
Trainer against the JAX step's gradients and loss parts (harness:
tests/test_torch_step_common.py), plain and with `fast=True` (their k3
ConvBlock convs on conv_valid_fast's plain versions on the CPU). No batch
norm: the optimizer after the gradients is the one tests/test_torch_train.py
holds. MAFusion takes weight seed 1: at seed 0 the port's own f32 gradient
of DB2's conv1 lies 1.4e-4 of the largest from its float64 one (a
cancelling sum; the JAX package's float64 agrees with the port's to
5.5e-8), at seed 1 every gradient within 4.4e-6."""

import pytest

import test_torch_step_common as sc

MODELS = ("nestfuse", "rfnnest", "mafusion")
SEEDS = {"mafusion": 1}


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_step_matches_jax(name, fast):
    sc.check_step(name, fast, seed=SEEDS.get(name, 0))
