"""The port's int8 inference of MyFusion's transformer_fs_elem
configuration (the Attention's q, k, v and proj on conv_int8, its pools
float) and its calibration, against the JAX package's int8 route on the
CPU (harness and tolerances: tests/test_torch_int8_common.py). It flips
four of its 7.7 million quanta at these inputs, which its decoder spreads
over the fused image: it holds the replay of the JAX integers and the flip
count only."""

import test_torch_int8_common as common


def test_calibrate_matches_jax():
    common.check_calibrate("myfusion_transformer_fs_elem")


def test_models_int8_vs_jax():
    common.check_int8("myfusion_transformer_fs_elem", flip_free=False)
