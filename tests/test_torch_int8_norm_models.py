"""The port's int8 inference of the normed models PMGI (batch norms, two
gray legs into conv_int8) and SEDRFuse (group norms; stride-2 and
transpose convs float), and their calibration, against the JAX package's
int8 route on the CPU (harness and tolerances:
tests/test_torch_int8_common.py)."""

import pytest

import test_torch_int8_common as common

KEYS = ["pmgi", "sedrfuse"]


@pytest.mark.parametrize("key", KEYS)
def test_calibrate_matches_jax(key):
    common.check_calibrate(key)


@pytest.mark.parametrize("key", KEYS)
def test_models_int8_vs_jax(key):
    common.check_int8(key)
