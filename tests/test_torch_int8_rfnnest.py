"""The port's int8 inference of RFNNest (NestFuse's encoder and decoder
around the residual fusion network) and its calibration, against the JAX
package's int8 route on the CPU (harness and tolerances:
tests/test_torch_int8_common.py). Its own quantizer flips 12 of its 6.1
million quanta at these inputs (torch on one thread; none on eight), which
its fusion network and decoder spread to up to 8.5e-3 of the fused
image's largest value (mean 7.0e-4, 14 % of the JAX int8 forward's own
quantization error): it holds the replay of the JAX integers and the flip
count only."""

import test_torch_int8_common as common


def test_calibrate_matches_jax():
    common.check_calibrate("rfnnest")


def test_models_int8_vs_jax():
    common.check_int8("rfnnest", flip_free=False)
