"""The port's int8 inference of NestFuse (the nested decoder over legs read
in place, max-pool downs) and its calibration, against the JAX package's
int8 route on the CPU (harness and tolerances:
tests/test_torch_int8_common.py)."""

import test_torch_int8_common as common


def test_calibrate_matches_jax():
    common.check_calibrate("nestfuse")


def test_models_int8_vs_jax():
    common.check_int8("nestfuse")
