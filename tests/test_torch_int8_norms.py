"""The int8 route of a normed conv (ops/layers.py ConvLayer under
ops/quant.quantized_inference) and the int8 gate, against the JAX
package's ConvLayer under its quantized_inference with the real kernel
(conv_tlane_dma_q in the Pallas interpreter, MMIF_CHAIN_INTERPRET=1), on
the CPU, with the same weights and amax on both sides; and IFCNN's and
DIFNet's int8 forwards and calibration against the JAX package's (harness:
tests/test_torch_int8_common.py).

- A batch norm rides conv_int8's f32 epilogue (dequant scale sw * g, bias
  (b - mean) * g + beta, then the activation); a group or layer norm and
  an activation no kernel fuses follow the kernel. Both sides take the
  same int8 grid (the raw weights times the fold, quantized), so the layer
  agrees within 2e-5 of max|y|. The control, the norm applied after the
  kernel's activation (what removing the refusal alone would run), misses.
- Int8Weights made for the unfolded scale and bias do not hold for the
  folded ones.
- The gate is the JAX package's: depthwise, strided, VALID and transpose
  convs stay float.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_int8_common as common

from multi_modal_image_fusion_tpu.ops import quant as jquant
from multi_modal_image_fusion_tpu.ops.layers import ConvLayer as JConvLayer
from multi_modal_image_fusion_tpu_torch.ops import layers
from multi_modal_image_fusion_tpu_torch.ops import quant
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
    Int8Weights, conv_int8)
from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer

LAYER_REL = 2e-5
CIN, COUT, K = 12, 16, 3


def _layer_case(norm, act, seed=0):
    """(JAX variables, port layer, x, amax) of a k3 12 -> 16 conv with its
    bias and `norm`, the same seeded weights on both sides."""
    r = np.random.RandomState(seed)
    w = (r.randn(K, K, CIN, COUT) * np.sqrt(2.0 / (K * K * CIN))).astype(
        np.float32)
    b = (0.2 * (r.rand(COUT) - 0.5)).astype(np.float32)
    scale = (0.5 + r.rand(COUT)).astype(np.float32)
    shift = (0.2 * (r.rand(COUT) - 0.5)).astype(np.float32)
    mean = (0.2 * (r.rand(COUT) - 0.5)).astype(np.float32)
    var = (0.5 + 1.5 * r.rand(COUT)).astype(np.float32)
    x = (r.rand(2, 13, 17, CIN) - 0.3).astype(np.float32)
    params = {"kernel": w, "bias": b}
    variables = {"params": params}
    layer = ConvLayer(CIN, COUT, K, act=act, norm=norm)
    sd = {"layers.0.weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
          "layers.0.bias": torch.from_numpy(b)}
    if norm == "batch":
        params["norm"] = {"scale": scale, "bias": shift}
        variables["batch_stats"] = {"norm": {"mean": mean, "var": var}}
        sd.update({"layers.1.weight": torch.from_numpy(scale),
                   "layers.1.bias": torch.from_numpy(shift),
                   "layers.1.running_mean": torch.from_numpy(mean),
                   "layers.1.running_var": torch.from_numpy(var),
                   "layers.1.num_batches_tracked": torch.tensor(0)})
    elif norm == "group":
        params["norm"] = {"scale": scale, "bias": shift}
        sd.update({"layers.1.weight": torch.from_numpy(scale),
                   "layers.1.bias": torch.from_numpy(shift)})
    elif norm == "layer":
        params["norm"] = {"scale": scale}
        sd["layers.1.weight"] = torch.from_numpy(scale.reshape(COUT, 1, 1))
    layer.load_state_dict(sd)
    layer.eval()
    layer.qpath = "conv"
    amax = (np.abs(x).max(axis=(0, 1, 2)) * 1.25).astype(np.float32)
    return variables, layer, x, amax


def _jax_int8(variables, norm, act, x, amax):
    jl = JConvLayer(COUT, K, norm=norm, act=act)
    with common.setenv("MMIF_CHAIN_INTERPRET", "1"), \
            jquant.quantized_inference({"": amax}):
        return np.asarray(jl.apply(variables, jnp.asarray(x), train=False))


def _port_int8(layer, x, amax):
    with quant.quantized_inference({"conv": amax}), torch.no_grad():
        return layer(torch.from_numpy(x)).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("norm", ["batch", "group", "layer"])
@pytest.mark.parametrize("act", ["relu", "hswish"])
def test_normed_layer_int8_vs_jax(norm, act):
    """relu is fused in the kernel's epilogue (after a batch norm folded
    there), hswish runs after the kernel; a group or layer norm follows
    the kernel on both."""
    variables, layer, x, amax = _layer_case(norm, act)
    want = _jax_int8(variables, norm, act, x, amax)
    got = _port_int8(layer, x, amax)
    with jax.default_matmul_precision("float32"):
        want32 = np.asarray(JConvLayer(COUT, K, norm=norm, act=act).apply(
            variables, jnp.asarray(x), train=False))
    assert got.shape == want.shape == (2, 13, 17, COUT)
    assert _rel(got, want) <= LAYER_REL, _rel(got, want)
    assert _rel(want, want32) > 1e-3          # the int8 route ran


def test_control_batch_norm_after_activation_misses(monkeypatch):
    """The control: the kernel's relu before the batch norm (conv_int8 with
    the unfolded scale and bias, the norm after it) misses JAX by far more
    than the layer tolerance."""
    variables, layer, x, amax = _layer_case("batch", "relu")
    want = _jax_int8(variables, "batch", "relu", x, amax)
    bn = layer.layers[1]
    monkeypatch.setattr(ConvLayer, "int8_epilogue",
                        lambda self, sw: (sw, self.bias))
    monkeypatch.setattr(ConvLayer, "_normed",
                        lambda self, y: layers.batch_norm(y, bn))
    got = _port_int8(layer, x, amax)
    assert _rel(got, want) > 100 * LAYER_REL


def test_int8_weights_for_the_unfolded_epilogue_refused():
    """Int8Weights made from the unfolded (sw, bias) do not hold for the
    batch norm's folded epilogue: conv_int8 refuses them."""
    _, layer, x, amax = _layer_case("batch", "relu")
    f = quant.choose_fold(amax, layer.weight)
    qw, sw = quant.quantize_weights(quant.fold_weights(layer.weight, f))
    dq, bias = layer.int8_epilogue(sw)
    stale = Int8Weights(qw, sw, layer.bias, f)
    assert not stale.holds(qw, dq, bias, f)
    with pytest.raises(ValueError, match="other tensors"):
        conv_int8(torch.from_numpy(x), qw, dq, f, bias, "relu",
                  weights=stale)


@pytest.mark.parametrize("kw,eligible", [
    (dict(), True),
    (dict(ksize=1), True),
    (dict(norm="batch"), True),
    (dict(norm="group", act=None), True),
    (dict(groups=16, in_ch=16), False),               # depthwise
    (dict(stride=2), False),                          # strided down
    (dict(groups=16, in_ch=16, ksize=2, stride=2, padding=0), False),
    (dict(stride=2, transpose=True, in_ch=16), False),
])
def test_gate_is_the_jax_packages(kw, eligible):
    """ConvLayer's int8 gate against the JAX package's (ops/layers.py:
    628-634: stride 1, groups 1, not transposed, pad k // 2), and under
    quantized_inference conv_int8 runs exactly on the admitted layers."""
    kw = {"in_ch": 8, "out_ch": 16, "ksize": 3, **kw}
    layer = ConvLayer(kw.pop("in_ch"), kw.pop("out_ch"), **kw).eval()
    pad = kw.get("ksize") // 2 if kw.get("padding") is None else 0
    jax_gate = (kw.get("stride", 1) == 1 and kw.get("groups", 1) == 1
                and not kw.get("transpose", False)
                and pad == kw.get("ksize") // 2)
    assert layer._int8_eligible() == jax_gate == eligible
    calls = []
    real = layers.conv_int8

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    layers.conv_int8 = spy
    try:
        x = torch.rand(2, 8, 12, layer.in_ch)
        with quant.quantized_inference({}), torch.no_grad():
            layer(x)
    finally:
        layers.conv_int8 = real
    assert bool(calls) == eligible


@pytest.mark.parametrize("key", ["ifcnn", "difnet"])
def test_calibrate_matches_jax(key):
    common.check_calibrate(key)


@pytest.mark.parametrize("key", ["ifcnn", "difnet"])
def test_models_int8_vs_jax(key):
    common.check_int8(key)
