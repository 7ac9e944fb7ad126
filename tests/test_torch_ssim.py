"""The port's SSIM (plain version, CPU) against the JAX package.

- plain `ssim_maps` against `ssim_maps_pallas(..., interpret=True)` and the
  JAX `ssim_maps`: 1e-5 (f32 on both sides, another summation order);
- `calc_ssim` against the reference goldens (tests/golden/metrics.npz) and
  the JAX `calc_ssim`: 1e-4 (docs/PARITY.md metric budget).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import nchw_to_nhwc

from multi_modal_image_fusion_tpu.ops import metrics as JM
from multi_modal_image_fusion_tpu.ops import ssim as JS
from multi_modal_image_fusion_tpu.ops.pallas.ssim_kernel import \
    ssim_maps_pallas
from multi_modal_image_fusion_tpu_torch.ops import ssim as S
from multi_modal_image_fusion_tpu_torch.ops.cuda.ssim_kernel import ssim_maps
from multi_modal_image_fusion_tpu_torch.ops.metrics import calc_ssim


def _pair(seed, n, h, w):
    r = np.random.RandomState(seed)
    a = r.rand(n, h, w, 1).astype(np.float32)
    b = np.clip(a + 0.2 * (r.rand(n, h, w, 1) - 0.5), 0, 1).astype(
        np.float32)
    return a, b


def test_gaussian_taps_match():
    for ws in (3, 7, 11):
        s = S.default_sigma(ws)
        assert s == JS.default_sigma(ws)
        np.testing.assert_array_equal(S.gaussian_kernel(ws, s),
                                      JS.gaussian_kernel(ws, s))


@pytest.mark.parametrize("ws,use_padding,data_range", [
    (11, False, 1.0), (11, True, 1.0), (7, False, 255.0)])
def test_ssim_maps_plain_vs_pallas_and_jax(ws, use_padding, data_range):
    a, b = _pair(0, 2, 150, 75)
    a, b = a * data_range, b * data_range
    got = ssim_maps(torch.from_numpy(a), torch.from_numpy(b), ws,
                    data_range, use_padding, sigma=1.5)
    want_k = ssim_maps_pallas(jnp.asarray(a), jnp.asarray(b), ws,
                              data_range, use_padding, sigma=1.5,
                              interpret=True)
    want_j = JS.ssim_maps(jnp.asarray(a), jnp.asarray(b),
                          JS.gaussian_kernel(ws, 1.5), data_range,
                          use_padding)
    for g, wk, wj in zip(got, want_k, want_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), atol=1e-5,
                                   rtol=1e-5)


def test_calc_ssim_vs_golden(golden):
    d = golden("metrics")
    x1, y = nchw_to_nhwc(d["x1"]), nchw_to_nhwc(d["y"])
    t1, ty = torch.from_numpy(x1), torch.from_numpy(y)
    np.testing.assert_allclose(float(calc_ssim(t1, ty)), d["ssim_255"],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        float(calc_ssim(t1 / 255.0, ty / 255.0, data_range=1.0)),
        d["ssim_1"], atol=1e-4, rtol=1e-4)
    s, c = calc_ssim(t1, ty, full=True)
    np.testing.assert_allclose([float(s), float(c)], d["ssim_cs"],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(1, 45, 61), (2, 8, 30)])
def test_calc_ssim_vs_jax(shape):
    """Includes an image smaller than the window (ws = min(11, h, w)) and
    the per-pixel map (size_average=False)."""
    a, b = _pair(1, *shape)
    got = calc_ssim(torch.from_numpy(a), torch.from_numpy(b),
                    data_range=1.0)
    want = JM.calc_ssim(jnp.asarray(a), jnp.asarray(b), data_range=1.0)
    np.testing.assert_allclose(float(got), float(want), atol=1e-4)
    got_map = calc_ssim(torch.from_numpy(a), torch.from_numpy(b),
                        data_range=1.0, size_average=False)
    want_map = JM.calc_ssim(jnp.asarray(a), jnp.asarray(b), data_range=1.0,
                            size_average=False)
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map),
                               atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 9, 23), (2, 7, 12), (2, 13, 3)])
def test_ssim_maps_plain_small_windows(shape):
    """Images below 11 pixels on a side, where calc_ssim picks the window
    min(11, h, w) (9, 7, 3): the plain maps against
    ssim_maps_pallas(..., interpret=True) at 1e-5, and calc_ssim against
    the JAX calc_ssim at 1e-4."""
    a, b = _pair(2, *shape)
    ws = min(11, *shape[1:])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = ssim_maps(ta, tb, ws, 1.0, sigma=1.5)
    want_k = ssim_maps_pallas(jnp.asarray(a), jnp.asarray(b), ws, 1.0,
                              sigma=1.5, interpret=True)
    for g, wk in zip(got, want_k):
        assert g.shape == np.asarray(wk).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(
        float(calc_ssim(ta, tb, data_range=1.0)),
        float(JM.calc_ssim(jnp.asarray(a), jnp.asarray(b), data_range=1.0)),
        atol=1e-4)
