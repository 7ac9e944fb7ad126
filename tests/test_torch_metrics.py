"""The port's metrics and histograms (CPU, plain versions) against the
reference goldens and the JAX package.

Tolerances (docs/PARITY.md metric budget): 1e-4 relative and absolute,
VIFF 1e-3 (its log-ratio sums amplify the filters' summation order);
histogram counts exactly.

- every value of tests/golden/metrics.npz (the reference PyTorch metrics
  on one 256x256 triple);
- every metric function against the JAX one on a seeded odd-size triple
  (197x251, 0..255);
- the histograms, exact, with values below 0, at 255.x and above 256;
- the batched `eval_metrics` bundle against `jax.vmap(eval_metrics)` per
  image, and per-image values independent of the batch they came in;
- VIF on a 40x40 image, whose last scale is smaller than its window:
  NaN for the weighted VIFF and a finite simple VIFF, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import nchw_to_nhwc

from multi_modal_image_fusion_tpu.ops import histogram as JH
from multi_modal_image_fusion_tpu.ops import metrics as JM
from multi_modal_image_fusion_tpu_torch.ops import histogram as H
from multi_modal_image_fusion_tpu_torch.ops import metrics as M

TOL = 1e-4
VIFF_TOL = 1e-3


def _check(got, want, tol=TOL):
    got = np.asarray(got.numpy() if torch.is_tensor(got) else got)
    np.testing.assert_allclose(got.reshape(np.shape(want)), want, rtol=tol,
                               atol=tol)


def _golden(golden):
    d = golden("metrics")
    return d, [torch.from_numpy(nchw_to_nhwc(d[k])) for k in ("x1", "x2",
                                                              "y")]


# golden key -> port computation on (x1, x2, y); information metrics on
# rounded images, as the reference's fixture generator computes them
_GOLDEN = {
    "mean": lambda a, b, y: M.calc_mean(y),
    "std": lambda a, b, y: M.calc_std(y),
    "ag": lambda a, b, y: M.calc_ag(y),
    "sf": lambda a, b, y: M.calc_sf(y),
    "mse": lambda a, b, y: M.calc_mse(a, y),
    "psnr": lambda a, b, y: M.calc_psnr(M.calc_mse(a, y)),
    "psnr_root": lambda a, b, y: M.calc_psnr(M.calc_mse(a, y), root=True),
    "cc": lambda a, b, y: M.calc_cc(a, y),
    "scd": lambda a, b, y: M.calc_scd(a, b, y),
    "entropy": lambda a, b, y: M.calc_entropy(torch.round(a)),
    "cross_ent": lambda a, b, y: M.calc_cross_ent(torch.round(a),
                                                  torch.round(y)),
    "joint_ent": lambda a, b, y: M.calc_joint_ent(torch.round(a),
                                                  torch.round(y)),
    "mi": lambda a, b, y: M.calc_mul_info(torch.round(a), torch.round(y)),
    "mi_norm": lambda a, b, y: M.calc_mul_info(torch.round(a),
                                               torch.round(y),
                                               normalized=True),
    "qabf": lambda a, b, y: M.calc_Qabf(a, b, y),
    "qabf_full": lambda a, b, y: torch.cat(M.calc_Qabf(a, b, y, full=True)),
    "nabf_mod": lambda a, b, y: M.calc_Nabf(a, b, y, modified=True),
    "nabf_orig": lambda a, b, y: M.calc_Nabf(a, b, y, modified=False),
    "labf": lambda a, b, y: M.calc_Labf(a, b, y),
    "ssim_255": lambda a, b, y: M.calc_ssim(a, y),
    "ssim_1": lambda a, b, y: M.calc_ssim(a / 255.0, y / 255.0,
                                          data_range=1.0),
    "ssim_cs": lambda a, b, y: torch.stack(M.calc_ssim(a, y, full=True)),
    "msssim": lambda a, b, y: M.calc_msssim(a, y),
    "viff_simple": lambda a, b, y: M.calc_viff(a, b, y, simple=True),
    "viff_weighted": lambda a, b, y: M.calc_viff(a, b, y, simple=False),
}


def test_golden_covers_every_key(golden):
    d = golden("metrics")
    assert sorted(_GOLDEN) == sorted(k for k in d.files
                                     if k not in ("x1", "x2", "y"))


@pytest.mark.parametrize("key", sorted(_GOLDEN))
def test_metric_vs_golden(golden, key):
    d, (a, b, y) = _golden(golden)
    tol = VIFF_TOL if key.startswith("viff") else TOL
    _check(_GOLDEN[key](a, b, y), d[key], tol)


def _triple(seed, n=1, h=197, w=251):
    r = np.random.RandomState(seed)
    a = (r.rand(n, h, w, 1) * 255).astype(np.float32)
    b = np.clip(255 - a * 0.6 + r.randn(n, h, w, 1) * 20, 0, 255).astype(
        np.float32)
    f = np.clip(0.5 * a + 0.5 * b + r.randn(n, h, w, 1) * 6, 0,
                255).astype(np.float32)
    return a, b, f


# name -> (function name in both packages, number of image arguments, kwargs)
_FUNCS = {
    "mean": ("calc_mean", 1, {}), "std": ("calc_std", 1, {}),
    "ag": ("calc_ag", 1, {}), "sf": ("calc_sf", 1, {}),
    "mse": ("calc_mse", 2, {}), "cc": ("calc_cc", 2, {}),
    "scd": ("calc_scd", 3, {}), "entropy": ("calc_entropy", 1, {}),
    "joint_ent": ("calc_joint_ent", 2, {}),
    "cross_ent": ("calc_cross_ent", 2, {}),
    "mul_info": ("calc_mul_info", 2, {}),
    "mul_info_norm": ("calc_mul_info", 2, {"normalized": True}),
    "qabf": ("calc_Qabf", 3, {}), "nabf": ("calc_Nabf", 3, {}),
    "nabf_orig": ("calc_Nabf", 3, {"modified": False}),
    "labf": ("calc_Labf", 3, {}), "ssim": ("calc_ssim", 2, {}),
    "ssim_pad": ("calc_ssim", 2, {"use_padding": True}),
    "msssim": ("calc_msssim", 2, {}),
    "viff": ("calc_viff", 3, {}),
    "viff_weighted": ("calc_viff", 3, {"simple": False}),
}


@pytest.mark.parametrize("name", sorted(_FUNCS))
def test_metric_vs_jax_odd_size(name):
    fn, n_img, kw = _FUNCS[name]
    imgs = _triple(1)[:n_img]
    got = getattr(M, fn)(*map(torch.from_numpy, imgs), **kw)
    with jax.default_matmul_precision("float32"):
        want = getattr(JM, fn)(*map(jnp.asarray, imgs), **kw)
    _check(got, np.asarray(want), VIFF_TOL if fn == "calc_viff" else TOL)


def test_psnr_and_qxy_vs_jax():
    a, b, f = _triple(2, h=45, w=61)
    mse = np.float32(0.0123)
    for root in (False, True):
        _check(M.calc_psnr(torch.tensor(mse), root=root),
               np.asarray(JM.calc_psnr(jnp.asarray(mse), root=root)))
    for mode in ("qabf", "nabf"):
        got = M.calc_Qxy(torch.from_numpy(a), torch.from_numpy(f), mode,
                         full=True)
        with jax.default_matmul_precision("float32"):
            want = JM.calc_Qxy(jnp.asarray(a), jnp.asarray(f), mode,
                               full=True)
        for g, w in zip(got, want):
            _check(g, np.asarray(w))
    with pytest.raises(ValueError):
        M.calc_Qxy(torch.from_numpy(a), torch.from_numpy(f), "other")


def test_histograms_exact():
    r = np.random.RandomState(3)
    x = (r.rand(2, 31, 37, 1) * 300 - 20).astype(np.float32)
    x[0, 0, :6, 0] = [-0.7, -1.0, 255.0, 255.9, 256.0, 1e4]
    y = (r.rand(2, 31, 37, 1) * 300 - 20).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(H.histogram256(tx).numpy(),
                                  np.asarray(JH.histogram256(jnp.asarray(x))))
    np.testing.assert_array_equal(
        H.joint_histogram256(tx, ty).numpy(),
        np.asarray(JH.joint_histogram256(jnp.asarray(x), jnp.asarray(y))))
    batched = H.histogram256_batched(tx)
    joint = H.joint_histogram256_batched(tx, ty)
    for i in range(2):
        np.testing.assert_array_equal(
            batched[i].numpy(), np.asarray(JH.histogram256(jnp.asarray(x[i]))))
        np.testing.assert_array_equal(
            joint[i].numpy(), np.asarray(JH.joint_histogram256(
                jnp.asarray(x[i]), jnp.asarray(y[i]))))
    assert float(batched.sum()) == x.size
    # bins: trunc toward zero, then clip to [0, 255]
    assert int(H.histogram256(torch.tensor([-0.7, 0.99, 255.5, 300.0]))[0]) \
        == 2
    assert int(H.histogram256(torch.tensor([-0.7, 0.99, 255.5, 300.0]))[255]) \
        == 2


def test_eval_bundle_vs_jax_vmap():
    a, b, f = _triple(4, n=3, h=64, w=72)
    got = M.eval_metrics(*map(torch.from_numpy, (a, b, f)))
    with jax.default_matmul_precision("float32"):
        want = jax.vmap(JM.eval_metrics)(
            *[jnp.asarray(v[:, None]) for v in (a, b, f)])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (3,), k
        _check(got[k], np.asarray(want[k]), VIFF_TOL if k == "viff" else TOL)


def test_eval_bundle_is_per_image():
    """Each image's values are the same alone as inside a batch."""
    a, b, f = _triple(5, n=3, h=40, w=48)
    batch = M.eval_metrics(*map(torch.from_numpy, (a, b, f)))
    for i in range(3):
        one = M.eval_metrics(*[torch.from_numpy(v[i:i + 1])
                               for v in (a, b, f)])
        for k in batch:
            np.testing.assert_allclose(one[k].numpy(), batch[k][i:i + 1],
                                       rtol=1e-5, atol=1e-6)


def test_vif_small_image_matches_jax():
    """40x40: the VIF pyramid's last scale is 2x2 against a 3-tap window,
    so its maps are empty; the weighted VIFF is NaN and the simple one
    finite, on both sides."""
    a, b, f = _triple(6, h=40, w=40)
    ta, tb, tf = map(torch.from_numpy, (a, b, f))
    ja, jb, jf = map(jnp.asarray, (a, b, f))
    vid, vind, g = M.calc_vif(ta, tf)
    jvid, jvind, jg = JM.calc_vif(ja, jf)
    for got, want in zip(vid + vind + g, jvid + jvind + jg):
        assert tuple(got.shape) == want.shape
        _check(got, np.asarray(want), VIFF_TOL)   # the VIF maps: VIFF's
    assert vid[3].shape == (1, 0, 0, 1)
    weighted = M.calc_viff(ta, tb, tf, simple=False)
    assert np.isnan(float(weighted))
    assert np.isnan(float(JM.calc_viff(ja, jb, jf, simple=False)))
    _check(M.calc_viff(ta, tb, tf),
           np.asarray(JM.calc_viff(ja, jb, jf)), VIFF_TOL)
    bundle = M.eval_metrics(ta, tb, tf)
    assert np.isnan(float(bundle["viff"]))
    assert all(np.isfinite(float(v)) for k, v in bundle.items()
               if k != "viff")
