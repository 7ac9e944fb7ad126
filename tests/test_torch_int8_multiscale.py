"""The port's int8 inference of the models whose float layers feed int8
layers, DBNet (stride-2 semantic branch and its x8 upsample), Res2Fusion
(depthwise convs, non-local attention fusion) and UNFusion (stride-2
downs, 'wavg' fusion, bilinear upsamples), against the JAX package's NHWC
int8 route with its real kernel (conv_tlane_dma_q in Pallas interpret
mode), on the CPU, with the same weights and amax on both sides
(tests/test_torch_int8_models.py has the helpers and the other models).

The float layers of the two packages agree to f32 rounding, and where such
noise puts a value on a quantization boundary the next int8 layer rounds it
to the neighbouring integer; each such flip spreads through the layers
after it. DBNet and Res2Fusion stay within tests/test_int8.py:121-128's
model tolerance (max <= 2e-2 and mean <= 1e-4 of max|y|). UNFusion's
multi-scale decoder spreads a flip at 1/8 scale over 64x the pixels: it is
held to the max bound and, for the mean, to 5 % of the mean quantization
error of the JAX int8 forward against its own f32 forward (a wrong scheme
differs by about that whole error; measured flips cost ~1 %). Its JAX side
runs under jax.jit with the amax passed as arguments (eagerly it takes
~70 s; the amax as traced values keep the fold out of constant folding),
which gave the eager result to the last bit on these inputs.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.ops import quant as jquant
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import quant
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict
from tests.test_torch_int8_models import (_both, _close, _pairs, _setenv,
                                          _variables)


@pytest.mark.parametrize("name", ["dbnet", "res2fusion"])
def test_models_int8_vs_jax(name):
    want, got, want32 = _both(name, _pairs(2, 2, 32, 40),
                              contextlib.nullcontext)
    _close(got, want)
    assert np.abs(want - want32).max() > 1e-3 * np.abs(want32).max()


def test_unfusion_int8_vs_jax():
    imgs = _pairs(2, 2, 32, 40)
    variables = _variables("unfusion")
    port = create_model("unfusion")
    port.load_state_dict(jax_to_state_dict(variables, "unfusion"))
    port.eval()
    amax = quant.calibrate(port, [tuple(torch.from_numpy(x) for x in imgs)])
    jm = jcreate("unfusion")

    def fwd(v, am, a, b):
        with jquant.quantized_inference(am):
            return jm.apply(v, a, b, train=False)
    with jax.default_matmul_precision("float32"):
        want32 = np.asarray(jax.jit(lambda v, a, b: jm.apply(
            v, a, b, train=False))(variables, *map(jnp.asarray, imgs)))
        with _setenv("MMIF_CHAIN_INTERPRET", "1"):
            want = np.asarray(jax.jit(fwd)(
                variables, {k: jnp.asarray(v) for k, v in amax.items()},
                *map(jnp.asarray, imgs)))
    with quant.quantized_inference(amax), torch.no_grad():
        got = port(*map(torch.from_numpy, imgs)).numpy()
    scale = float(np.abs(want).max())
    d = np.abs(got - want)
    q_err = float(np.abs(want - want32).mean())
    assert np.isfinite(got).all() and got.shape == want.shape
    assert d.max() <= 2e-2 * scale, d.max() / scale
    assert q_err > 1e-3 * scale                   # the int8 route ran
    assert d.mean() <= 0.05 * q_err, (d.mean() / scale, q_err / scale)
