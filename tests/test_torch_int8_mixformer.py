"""The port's int8 inference of MyFusion's mixformer_ls_concat
configuration (MixConv windows and FFN dw float) and its calibration,
against the JAX package's int8 route on the CPU (harness and tolerances:
tests/test_torch_int8_common.py). It flips one of its 6.8 million quanta
at these inputs, which its decoder spreads over the fused image: it holds
the replay of the JAX integers and the flip count only."""

import test_torch_int8_common as common


def test_calibrate_matches_jax():
    common.check_calibrate("myfusion_mixformer_ls_concat")


def test_models_int8_vs_jax():
    common.check_int8("myfusion_mixformer_ls_concat", flip_free=False)
