"""The port's fusion strategies (ops/fusion.py, CPU) against the reference
PyTorch goldens and the JAX package.

- every key of tests/golden/fusion.npz (reference core/fusion.py on
  seeded (2, 8, 32, 32) features), with the JAX tests' tolerances
  (tests/test_fusion.py): 1e-6 elementwise, 1e-5 pooling and attention,
  1e-4 for the double non-local attention, 1e-3 for the nuclear norm
  (SVD backends differ);
- `attention_fusion` against JAX's on the same seeded NHWC inputs, over
  its modes and pooling pairs, at an odd size whose 8x8 pool drops the
  remainder rows and columns (45x61 -> 5x7): 1e-5, 1e-4 with 'nl'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import nchw_to_nhwc, nhwc_to_nchw

from multi_modal_image_fusion_tpu.ops import fusion as JF
from multi_modal_image_fusion_tpu_torch.ops import fusion as F


def _load(golden):
    d = golden("fusion")
    return (d, torch.from_numpy(nchw_to_nhwc(d["t1"])),
            torch.from_numpy(nchw_to_nhwc(d["t2"])))


def _check(got, want, atol):
    np.testing.assert_allclose(nhwc_to_nchw(got.numpy()), want, atol=atol)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_element_fusion(golden, mode):
    d, t1, t2 = _load(golden)
    _check(F.element_fusion(t1, t2, mode), d[f"elem_{mode}"], 1e-6)


def test_weighted_fusion(golden):
    d, t1, t2 = _load(golden)
    _check(F.weighted_fusion(t1, t2, t1.mean(), t2.mean()), d["weighted"],
           1e-6)


@pytest.mark.parametrize("mode", ["sa", "ca", "sca", "wavg"])
def test_attention_fusion(golden, mode):
    d, t1, t2 = _load(golden)
    _check(F.attention_fusion(t1, t2, mode), d[f"attn_{mode}"], 1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean", "l1", "l2", "linf", "nl"])
def test_spatial_pooling(golden, mode):
    d, t1, _ = _load(golden)
    _check(F.spatial_pooling(t1, mode), d[f"spool_{mode}"], 1e-5)


@pytest.mark.parametrize("mode", ["avg", "max", "nuclear", "nl"])
def test_channel_pooling(golden, mode):
    d, t1, _ = _load(golden)
    _check(F.channel_pooling(t1, mode), d[f"cpool_{mode}"],
           1e-3 if mode == "nuclear" else 1e-5)


def test_attention_fusion_nonlocal(golden):
    d, t1, t2 = _load(golden)
    _check(F.attention_fusion(t1, t2, "sca", spatial_mode="nl",
                              channel_mode="nl"), d["attn_nl"], 1e-4)


def test_concat_fusion(golden):
    d, t1, t2 = _load(golden)
    got = F.concat_fusion((t1, t2))
    assert got.shape[-1] == 2 * t1.shape[-1]
    np.testing.assert_array_equal(got[..., :8].numpy(), t1.numpy())


@pytest.mark.parametrize("mode,spatial,channel", [
    ("sca", "nl", "nl"), ("sa", "nl", "avg"), ("ca", "l1", "nl"),
    ("wavg", "l2", "max"), ("sca", "linf", "nuclear"),
    ("ca", "mean", "avg")])
def test_attention_fusion_vs_jax(mode, spatial, channel):
    r = np.random.RandomState(21)
    t1 = r.rand(2, 45, 61, 8).astype(np.float32)
    t2 = r.rand(2, 45, 61, 8).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = JF.attention_fusion(jnp.asarray(t1), jnp.asarray(t2), mode,
                                   spatial, channel)
    got = F.attention_fusion(torch.from_numpy(t1), torch.from_numpy(t2), mode,
                             spatial, channel)
    atol = 1e-4 if "nl" in (spatial, channel) or channel == "nuclear" \
        else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_unknown_modes_raise():
    t = torch.zeros(1, 8, 8, 4)
    for call in (lambda: F.attention_fusion(t, t, "xx"),
                 lambda: F.spatial_pooling(t, "xx"),
                 lambda: F.channel_pooling(t, "xx")):
        with pytest.raises(ValueError):
            call()
