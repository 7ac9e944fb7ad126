"""The int8 forward of every model and configuration that serves in float
but DeepFuse, DenseFuse, VIFNet, DBNet, Res2Fusion and UNFusion (IFCNN,
DIFNet, PMGI, SEDRFuse, NestFuse, RFNNest, MAFusion, PFNetv1, PFNetv2,
MyFusion's default, sep with batch norms, mixformer_ls_concat and
transformer_fs_elem: chip_smoke.py INT8_MODELS) through the int8 kernels
against the plain int8 path on the card (`plain_int8`: the exact integer
conv and the same f32 epilogue), in bf16 and f32, on two seeded pairs of
256x256 calibrated on themselves:

- within tests/test_int8.py:121-128's model tolerance (max <= 2e-2 and
  mean <= 1e-4 of max|y|);
- one int8 forward launches exactly chip_smoke.py's
  INT8_FORWARD_LAUNCHES: conv_int8 once for each conv the int8 gate
  admits (ConvLayer._int8_eligible), the float kernels MyFusion's
  depthwise convs take, nothing else counted.

Weights: chip_smoke.py's `seeded_model` at the first live seed
(`live_seed`, MyFusion's MetaFormer configurations with its spread rule).
Needs a CUDA device and nvcc; every test skips without a card. Run on the
GPU machine from the checkout's root with (the JAX-importing conftest is
skipped):

    python -m pytest --noconftest tests/test_torch_int8_card.py
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from multi_modal_image_fusion_tpu_torch.ops.cuda import build
from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer
from multi_modal_image_fusion_tpu_torch.ops.quant import (
    calibrate, quantized_inference)
from test_torch_gray_card import cuda  # noqa: F401

KEYS = {key: (name, cfg) for key, name, cfg, _ in cs.INT8_MODELS}


def _model(key, dev):
    name, cfg = KEYS[key]
    spread = 1e-3 if key in cs.MYF_FORMERS else 0.0
    seed = cs.live_seed(torch, dev, name, key=key, min_spread=spread, **cfg)
    return cs.seeded_model(torch, name, seed, **cfg).to(dev).eval()


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("key", list(KEYS))
def test_int8_kernels_vs_plain(cuda, key, dt):
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    model = _model(key, cuda).to(dtype)
    r = np.random.RandomState(0)
    a, b = (torch.from_numpy(r.rand(2, 256, 256, 1).astype(np.float32))
            .to(cuda, dtype) for _ in range(2))
    amax = calibrate(model, [(a, b)])
    with torch.no_grad(), quantized_inference(amax):
        model(a, b)                       # packs the weights once
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        y = model(a, b).float()
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        with cs.plain_int8():
            yp = model(a, b).float()
    eligible = sum(1 for m in model.modules()
                   if isinstance(m, ConvLayer) and m._int8_eligible())
    assert counts == cs.INT8_FORWARD_LAUNCHES[key]
    # PMGI: its dead transfer1[1] runs in training only, its transfer2[1]
    # twice (the reference's quirks), so the count is the layers' too
    assert counts["conv_int8"] == eligible
    assert torch.isfinite(y).all() and y.shape == (2, 256, 256, 1)
    scale = float(yp.abs().max())
    d = (y - yp).abs()
    assert float(d.max()) <= 2e-2 * scale, float(d.max()) / scale
    assert float(d.mean()) <= 1e-4 * scale, float(d.mean()) / scale
