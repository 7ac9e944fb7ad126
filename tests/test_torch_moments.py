"""The port's moments plain version (CPU) against the JAX Pallas kernel
`moments_pallas(..., interpret=True)`, at the VIF pyramid's windows 17, 9, 5
and 3 (sigma ws / 5), VALID and with use_padding, at 1e-5 relative to the
largest moment (f32 on both sides, filters summed in another order). Also:
the wrapper takes the plain version for CPU tensors, and a pair smaller
than the window gives empty maps, as the JAX filters do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.ops.pallas.moments_kernel import \
    moments_pallas
from multi_modal_image_fusion_tpu.ops.ssim import gaussian_filter as \
    jgaussian_filter
from multi_modal_image_fusion_tpu_torch.ops.cuda.moments import (
    moments, moments_plain)
from multi_modal_image_fusion_tpu_torch.ops.ssim import gaussian_kernel


def _pair(seed, n, h, w):
    r = np.random.RandomState(seed)
    a = (r.rand(n, h, w, 1) * 255).astype(np.float32)
    b = np.clip(a * 0.7 + r.rand(n, h, w, 1) * 80, 0, 255).astype(np.float32)
    return a, b


@pytest.mark.parametrize("use_padding", [False, True])
@pytest.mark.parametrize("ws", [17, 9, 5, 3])
def test_moments_plain_vs_pallas(ws, use_padding):
    a, b = _pair(ws, 2, 37, 53)
    got = moments_plain(torch.from_numpy(a), torch.from_numpy(b),
                        gaussian_kernel(ws, ws / 5), use_padding)
    want = moments_pallas(jnp.asarray(a), jnp.asarray(b), ws, ws / 5,
                          use_padding, interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_moments_wrapper_on_cpu_is_plain():
    a, b = _pair(0, 1, 20, 24)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = moments(ta, tb, 5, 1.0)
    want = moments_plain(ta, tb, gaussian_kernel(5, 1.0))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_moments_smaller_than_window_is_empty():
    a, b = _pair(1, 2, 2, 2)
    got = moments(torch.from_numpy(a), torch.from_numpy(b), 3, 0.6)
    want = jgaussian_filter(jnp.asarray(a), gaussian_kernel(3, 0.6))
    assert want.shape == (2, 0, 0, 1)
    assert all(tuple(g.shape) == want.shape for g in got)


def test_vif_pyramid_40x38():
    """A 4-scale VIF pyramid of a 40x38 pair: each scale's moments (17, 9,
    5, 3 taps on 40x38, 16x15, 6x6, 2x2) against moments_pallas(...,
    interpret=True) where the level holds the window and against the JAX
    filters' empty maps where it does not (the last scale), at 1e-5 of the
    largest moment (the masking chain after them: tests/test_torch_metrics.
    py)."""
    a, b = _pair(5, 1, 40, 38)
    im1, im2 = torch.from_numpy(a), torch.from_numpy(b)
    j1, j2 = jnp.asarray(a), jnp.asarray(b)
    for scale in range(1, 5):
        ws = 2 ** (5 - scale) + 1
        taps = gaussian_kernel(ws, ws / 5)
        if scale > 1:
            im1, im2 = (moments_plain(x, x, taps)[0][:, ::2, ::2]
                        for x in (im1, im2))
            j1, j2 = (jgaussian_filter(x, taps)[:, ::2, ::2]
                      for x in (j1, j2))
        got = moments(im1, im2, ws, ws / 5)
        if min(im1.shape[1:3]) >= ws:
            want = moments_pallas(j1, j2, ws, ws / 5, interpret=True)
        else:
            want = [jgaussian_filter(x, taps) for x in
                    (j1, j2, j1 * j1, j2 * j2, j1 * j2)]
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            if w.size:
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=1e-5 * np.abs(w).max())
