"""conv_dw (csrc/conv_dw.cu) against its plain version, on the card.

Needs a CUDA device and nvcc; every test skips without a card. Run on the
GPU machine with (the JAX-importing conftest is skipped):

    python -m pytest --noconftest tests/test_torch_conv_dw_card.py

Layers: Res2Fusion's depthwise windows (RB1: 16 of 64 channels, RB2: 48 of
384; k1 at dw0, k3 after, the add of the previous group's output from dw2
on), with no bias or activation as the model runs them and with a bias and
an activation. Shapes: H and W that are not multiples of the tile (64
columns), images of 2 and 3 pixels a side (k3's reflect indexes inside
the halo), a batch of 3, and the Res2Fusion bench's 4x1224x1024 (bf16) and
the test CLI's 2x1224x1024 (f32). Tolerances, relative to the largest
magnitude of the plain output (F.conv2d(groups=C) in f32, TF32 off): f32
1e-4, bf16 2e-2 (tests/test_torch_kernels.py). Each call is one counted
launch and two calls give the same bits. Controls that must miss by more
than the tolerance: the plain output of a zero halo, and of the window
shifted by 8 channels.
"""

import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu_torch.ops.cuda import build
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import apply_act
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_dw import (
    conv_dw, conv_dw_plain)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (name, channels of the expanded tensor, group width, k, window base,
# with the add)
LAYERS = [("RB1.dw0", 64, 16, 1, 0, False), ("RB1.dw1", 64, 16, 3, 16, False),
          ("RB1.dw3", 64, 16, 3, 48, True), ("RB2.dw0", 384, 48, 1, 0, False),
          ("RB2.dw1", 384, 48, 3, 48, False),
          ("RB2.dw7", 384, 48, 3, 336, True)]
# ragged tiles, a batch of 3, images 2 and 3 pixels a side
SHAPES = [(2, 37, 70), (3, 45, 61), (1, 2, 3), (3, 3, 2), (2, 130, 129)]
EPILOGUES = {"plain": (False, None), "bias_relu6": (True, "relu6")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(layer, shape, dtype, with_bias, dev):
    _, cx, c, k, lo, with_add = layer
    b, h, w = shape
    g = torch.Generator(device=dev).manual_seed(cx + c + k + lo + h + w)
    x = ((torch.rand((b, h, w, cx), generator=g, device=dev) - 0.3) * 6
         ).to(dtype)
    wt = ((torch.rand((c, 1, k, k), generator=g, device=dev) - 0.5) * 2 / k
          ).to(dtype)
    bias = (torch.rand((c,), generator=g, device=dev) - 0.5
            if with_bias else None)
    add = ((torch.rand((b, h, w, c), generator=g, device=dev) - 0.3) * 3
           ).to(dtype) if with_add else None
    return x, wt, bias, add


def _rel(got, want):
    got, want = got.double(), want.double()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1.0)


@pytest.mark.parametrize("epi", sorted(EPILOGUES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("layer", LAYERS, ids=lambda c: c[0])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_conv_dw_layer(cuda, dt, layer, shape, epi):
    dtype = DTYPES[dt]
    with_bias, act = EPILOGUES[epi]
    x, wt, bias, add = _inputs(layer, shape, dtype, with_bias, cuda)
    lo = layer[4]
    before = build.LAUNCHES["conv_dw"]
    got = conv_dw(x, wt, bias, act, lo, add)
    again = conv_dw(x, wt, bias, act, lo, add)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_dw"] == before + 2
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, again)
    assert _rel(got, conv_dw_plain(x, wt, bias, act, lo, add)) <= TOL[dtype]


@pytest.mark.parametrize("layer", LAYERS, ids=lambda c: c[0])
@pytest.mark.parametrize("dt,shape", [("bf16", (4, 1224, 1024)),
                                      ("f32", (2, 1224, 1024))])
def test_conv_dw_bench_shape(cuda, dt, shape, layer):
    """Every layer at the Res2Fusion bench's shape (bf16) and the test CLI's
    pair (f32), with the controls: the window shifted by 8 channels (and,
    at k3, a zero halo) must miss."""
    dtype = DTYPES[dt]
    x, wt, _, add = _inputs(layer, shape, dtype, False, cuda)
    _, cx, c, k, lo, _ = layer
    got = conv_dw(x, wt, None, None, lo, add)
    want = conv_dw_plain(x, wt, None, None, lo, add)
    assert _rel(got, want) <= TOL[dtype]
    shifted = lo + 8 if lo + 8 + c <= cx else lo - 8
    assert _rel(got, conv_dw_plain(x, wt, None, None, shifted, add)) \
        > TOL[dtype]
    if k > 1:
        xin = x[..., lo:lo + c].float()
        if add is not None:
            xin = xin + add.float()
        zero = F.conv2d(F.pad(xin.permute(0, 3, 1, 2), (1, 1, 1, 1)),
                        wt.float(), groups=c).permute(0, 2, 3, 1)
        assert _rel(got, zero.to(dtype)) > TOL[dtype]


def test_conv_dw_repacks_changed_weight(cuda):
    """A weight changed in place (a checkpoint load, an optimizer step) is
    packed anew: the next call computes with the new taps."""
    layer = LAYERS[2]
    x, wt, bias, add = _inputs(layer, (2, 37, 70), torch.float32, True, cuda)
    lo = layer[4]
    first = conv_dw(x, wt, bias, "relu", lo, add)
    with torch.no_grad():
        wt.mul_(-2.0)
        bias.add_(1.0)
    got = conv_dw(x, wt, bias, "relu", lo, add)
    assert _rel(got, conv_dw_plain(x, wt, bias, "relu", lo, add)) <= 1e-4
    assert _rel(got, first) > 1e-4
    assert torch.equal(apply_act(got, "relu"), got)
