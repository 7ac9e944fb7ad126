"""ssim_maps and moments (csrc/window_stencil.cuh, the body of csrc/ssim.cu
and csrc/moments.cu) against their plain versions, on the card.

Needs a CUDA device and nvcc; every test skips without a card. Run on the
GPU machine with (the JAX-importing conftest is skipped):

    python -m pytest --noconftest tests/test_torch_window_card.py

Shapes: the test CLI's pair (1x1224x1024, ws 11), the eval chunk's
16x1224x1024 and its MS-SSIM levels (612x512 to 77x64, ws 11), the VIF
scales of an eval chunk (1224x1024 ws 17, 608x508 ws 9, 302x252 ws 5,
150x125 ws 3), batch 1 at 1224x1024 for moments, and at every templated
window and a generic one (7, and 8 for ssim): a ragged width (517, not a
multiple of 4: the 4-byte copies; its last band partial), an image of
less than one strip (40x50), and a strip whose last row group is partial
(203 rows). f32, TF32 off, within 1e-4 of max(|y|, 1) of each map (the
same f32 FMAs in tap order; the plain filters sum in cuDNN's order).
Controls that must miss by 10x: the plain maps of the input shifted by
one row, and of the input shifted by one column.
"""

import pytest
import torch

from multi_modal_image_fusion_tpu_torch.ops.cuda import build
from multi_modal_image_fusion_tpu_torch.ops.cuda.moments import (
    moments, moments_plain)
from multi_modal_image_fusion_tpu_torch.ops.cuda.ssim_kernel import (
    ssim_maps, ssim_maps_plain)
from multi_modal_image_fusion_tpu_torch.ops.ssim import gaussian_kernel

TOL = 1e-4
# (n, h, w, ws, data range): ssim_maps as the test and eval CLIs launch it
SSIM_CASES = [(1, 1224, 1024, 11, 1.0), (16, 1224, 1024, 11, 255.0),
              (16, 612, 512, 11, 255.0), (16, 306, 256, 11, 255.0),
              (16, 153, 128, 11, 255.0), (16, 77, 64, 11, 255.0),
              (2, 45, 61, 7, 255.0), (3, 9, 30, 8, 1.0)]
# (n, h, w, ws): moments at the VIF scales of an eval chunk, batch 1
MOMENT_CASES = [(16, 1224, 1024, 17), (16, 608, 508, 9), (16, 302, 252, 5),
                (16, 150, 125, 3), (1, 1224, 1024, 17), (2, 45, 61, 7)]
# ragged width, less than one strip, a partial last row group
EDGE_SHAPES = [(1, 203, 517), (2, 40, 50)]
EDGE_CASES = ([(n, h, w, 11, 255.0) for n, h, w in EDGE_SHAPES]
              + [(n, h, w, 8, 1.0) for n, h, w in EDGE_SHAPES],
              [(n, h, w, ws) for n, h, w in EDGE_SHAPES
               for ws in (17, 9, 5, 3, 7)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(n, h, w, scale, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand((n, h, w, 1), generator=g, device=dev) * scale
    b = (0.6 * a + 0.4 * scale * torch.rand((n, h, w, 1), generator=g,
                                            device=dev)).clamp(0, scale)
    return a, b


def _rel(got, want):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1.0)


def _hold(name, call, plain, a, b):
    """One launch, each map within TOL of the plain version's; the plain
    maps of the pair shifted by one row and by one column miss by 10x."""
    before = build.LAUNCHES[name]
    got = call(a, b)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    for g, w_ in zip(got, plain(a, b)):
        assert _rel(g, w_) <= TOL
    rows = plain(a[:, 1:], b[:, 1:])
    cols = plain(a[:, :, 1:], b[:, :, 1:])
    for g, r, c in zip(got, rows, cols):
        assert _rel(g[:, :-1], r) > 10 * TOL
        assert _rel(g[:, :, :-1], c) > 10 * TOL


@pytest.mark.parametrize("case", SSIM_CASES + EDGE_CASES[0],
                         ids=lambda c: "x".join(map(str, c)))
def test_ssim_maps_window(cuda, case):
    n, h, w, ws, rng = case
    a, b = _pair(n, h, w, rng, ws + h, cuda)
    taps = gaussian_kernel(ws, 1.5)
    _hold("ssim_maps", lambda x, y: ssim_maps(x, y, ws, rng, False, 1.5),
          lambda x, y: ssim_maps_plain(x, y, taps, rng), a, b)


@pytest.mark.parametrize("case", MOMENT_CASES + EDGE_CASES[1],
                         ids=lambda c: "x".join(map(str, c)))
def test_moments_window(cuda, case):
    n, h, w, ws = case
    a, b = _pair(n, h, w, 255.0, ws + h, cuda)
    taps = gaussian_kernel(ws, ws / 5)
    _hold("moments", lambda x, y: moments(x, y, ws, ws / 5),
          lambda x, y: moments_plain(x, y, taps), a, b)


def test_window_offset_pair(cuda):
    """A pair that is not 16-byte aligned (a view one pixel into its
    storage) takes the 4-byte copies and gives the same maps."""
    a, b = _pair(1, 101, 133, 255.0, 7, cuda)
    a1, b1 = (x.flatten()[1:1 + 101 * 132].view(1, 101, 132, 1)
              for x in (a, b))
    assert a1.data_ptr() % 16
    taps = gaussian_kernel(9, 1.8)
    for g, w_ in zip(moments(a1, b1, 9, 1.8), moments_plain(a1, b1, taps)):
        assert _rel(g, w_) <= TOL
