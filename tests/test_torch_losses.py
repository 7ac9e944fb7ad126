"""The port's training losses (ops/losses.py, CPU) against the PyTorch
reference goldens (tests/golden/losses.npz) and the JAX package's losses.

Tolerance 2e-5 absolute, the docs/PARITY.md budget for losses: f32 on
every side, and the SSIM filters sum their taps in another order than the
JAX band-matrix matmuls (~1e-7), which the SSIM algebra's divisions and the
MS-SSIM powers amplify to a few 1e-6. Masks drop samples from the batch
average in both packages; gradients of the bundle w.r.t. the fused image
are held to 2e-5 of their largest magnitude for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import nchw_to_nhwc

from multi_modal_image_fusion_tpu.ops import losses as JL
from multi_modal_image_fusion_tpu.train.trainer import \
    make_loss_bundle as jax_bundle
from multi_modal_image_fusion_tpu_torch.ops import losses as L
from multi_modal_image_fusion_tpu_torch.train.trainer import make_loss_bundle

ATOL = 2e-5


def _golden(golden):
    d = golden("losses")
    return d, tuple(torch.from_numpy(np.ascontiguousarray(nchw_to_nhwc(d[k])))
                    for k in ("x1", "x2", "y"))


@pytest.mark.parametrize("mode", ["ssim", "w-ssim", "ms-ssim", "msw-ssim"])
def test_ssim_loss_golden(golden, mode):
    d, (x1, x2, y) = _golden(golden)
    got = float(L.SSIMLoss(mode, weight=1.0)(x1, x2, y))
    np.testing.assert_allclose(got, d[f"ssimloss_{mode}"], atol=ATOL)


@pytest.mark.parametrize("mode", ["l1", "l2"])
@pytest.mark.parametrize("m", ["avg", "max"])
def test_pixel_grad_loss_golden(golden, mode, m):
    d, (x1, x2, y) = _golden(golden)
    got = float(L.PixelLoss(mode, weight=1.0)(x1, x2, y, mode=m))
    np.testing.assert_allclose(got, d[f"pixel_{mode}_{m}"], atol=ATOL)
    got = float(L.GradLoss(mode, weight=1.0)(x1, x2, y, mode=m))
    np.testing.assert_allclose(got, d[f"grad_{mode}_{m}"], atol=ATOL)


@pytest.mark.parametrize("mode", ["l1", "l2"])
def test_tv_norm_loss_golden(golden, mode):
    d, (x1, _, y) = _golden(golden)
    np.testing.assert_allclose(float(L.TVLoss(mode, weight=1.0)(y - x1)),
                               d[f"tv_{mode}"], atol=ATOL)
    np.testing.assert_allclose(float(L.NormLoss(mode, weight=1.0)(y - x1)),
                               d[f"norm_{mode}"], atol=ATOL)


def test_calc_ssim_and_msssim_golden(golden):
    d, (x1, _, y) = _golden(golden)
    out = L.calc_ssim(x1, y, data_range=1.0)
    for key in ("ssim", "cs", "sigma"):
        np.testing.assert_allclose(out[key].numpy(), d[f"{key}_vec"],
                                   atol=ATOL)
    out = L.calc_ssim(x1, y, data_range=1.0, use_padding=True,
                      size_average=False)
    np.testing.assert_allclose(out["ssim"].permute(0, 3, 1, 2).numpy(),
                               d["ssim_map"], atol=ATOL)
    np.testing.assert_allclose(L.calc_msssim(x1, y, data_range=1.0).numpy(),
                               d["msssim_vec"], atol=ATOL)


def _inputs(seed, n=3, h=40, w=52):
    r = np.random.RandomState(seed)
    x1 = r.rand(n, h, w, 1).astype(np.float32)
    x2 = r.rand(n, h, w, 1).astype(np.float32)
    y = np.clip(0.5 * (x1 + x2) + 0.1 * (r.rand(n, h, w, 1) - 0.5), 0,
                1).astype(np.float32)
    return x1, x2, y


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["ssim", "w-ssim", "ms-ssim", "msw-ssim"])
def test_ssim_loss_matches_jax(mode, masked):
    x1, x2, y = _inputs(1, h=176, w=180)   # MS-SSIM's 5th level: 11x11
    mask = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    want = float(JL.SSIMLoss(mode)(x1, x2, y,
                                   mask=None if mask is None
                                   else jnp.asarray(mask)))
    got = float(L.SSIMLoss(mode)(*map(torch.from_numpy, (x1, x2, y)),
                                 mask=None if mask is None
                                 else torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m", ["avg", "max"])
@pytest.mark.parametrize("mode", ["l1", "l2"])
def test_pixel_grad_loss_matches_jax(mode, m, masked):
    x1, x2, y = _inputs(2)
    mask = np.array([0.0, 1.0, 1.0], np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    t = tuple(map(torch.from_numpy, (x1, x2, y)))
    for jfn, tfn in ((JL.PixelLoss(mode, 0.5), L.PixelLoss(mode, 0.5)),
                     (JL.GradLoss(mode, 0.5), L.GradLoss(mode, 0.5))):
        np.testing.assert_allclose(float(tfn(*t, mode=m, mask=tm)),
                                   float(jfn(x1, x2, y, mode=m, mask=jm)),
                                   atol=ATOL)


def test_sobel_and_data_range_match_jax():
    x1, _, _ = _inputs(3)
    for got, want in zip(L.sobel_xy(torch.from_numpy(x1)),
                         JL.sobel_xy(jnp.asarray(x1))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    from multi_modal_image_fusion_tpu.ops.ssim import \
        infer_data_range as jrange
    from multi_modal_image_fusion_tpu_torch.ops.ssim import infer_data_range
    for scale, shift in ((1.0, 0.0), (255.0, 0.0), (2.0, -1.0)):
        x = x1 * scale + shift
        assert float(infer_data_range(torch.from_numpy(x))) == \
            float(jrange(jnp.asarray(x)))
    # data_range inferred inside calc_ssim, at an 8-bit scale
    got = L.calc_ssim(torch.from_numpy(x1 * 255), torch.from_numpy(x1 * 250))
    want = JL.calc_ssim(jnp.asarray(x1 * 255), jnp.asarray(x1 * 250))
    np.testing.assert_allclose(got["ssim"].numpy(), np.asarray(want["ssim"]),
                               atol=ATOL)


@pytest.mark.parametrize("ssim_mode", ["ssim", "msw-ssim"])
def test_bundle_value_and_gradient_match_jax(ssim_mode):
    """The reference 3-loss bundle and its gradient w.r.t. the fused image."""
    x1, x2, y = _inputs(4, n=2, h=48, w=48)
    jb = jax_bundle(ssim_mode)
    (jt, jparts), jg = jax.value_and_grad(
        lambda yy: jb(x1, x2, yy), has_aux=True)(jnp.asarray(y))
    yt = torch.from_numpy(y).requires_grad_()
    total, parts = make_loss_bundle(ssim_mode)(torch.from_numpy(x1),
                                               torch.from_numpy(x2), yt)
    total.backward()
    for k in ("loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]),
                                   atol=ATOL)
    jg = np.asarray(jg)
    assert float(np.abs(yt.grad.numpy() - jg).max()) <= \
        ATOL * float(np.abs(jg).max())
