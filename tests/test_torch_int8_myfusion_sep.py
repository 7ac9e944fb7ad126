"""The port's int8 inference of MyFusion with `norm="batch"` (the sep
encoder; the batch norms ride conv_int8's epilogue, the depthwise convs
stay float) and its calibration, against the JAX package's int8 route on
the CPU (harness and tolerances: tests/test_torch_int8_common.py)."""

import test_torch_int8_common as common


def test_calibrate_matches_jax():
    common.check_calibrate("myfusion_sep_batch")


def test_models_int8_vs_jax():
    common.check_int8("myfusion_sep_batch")
