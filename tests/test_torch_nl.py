"""The port's non-local spatial attention (ops/cuda/nl_attention.py, plain
versions on the CPU) against the JAX package.

- `nl_spatial_plain` with one block (the dense math) and with ragged
  blocks against JAX `nl_spatial_flash` in Pallas interpret mode and
  `_nl_spatial_blocked`, at tests/test_nl_kernel.py's shapes: 1e-5 of the
  largest output magnitude in f32 (same f32 products, another summation
  order), 2e-2 in bf16 (bf16 outputs, weights cast to bf16 before the value
  product on both sides);
- the two passes apart: `nl_minmax_plain` is the batch-global (min, max)
  of the energies, `nl_apply_plain` the normalised softmax product;
- the wrappers' refusals, on tensors that are not on the CPU (meta
  tensors: the checks run before any launch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.ops import fusion as JF
from multi_modal_image_fusion_tpu.ops.pallas.nl_kernel import \
    nl_spatial_flash as jax_flash
from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
    nl_apply, nl_apply_plain, nl_minmax, nl_minmax_plain, nl_spatial_flash,
    nl_spatial_plain)


def _qk(seed, b, n, m, c):
    r = np.random.RandomState(seed)
    return ((r.rand(b, n, c) * 2 - 1).astype(np.float32),
            (r.rand(b, m, c) * 2 - 1).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("b,n,m,c", [(2, 1000, 70, 112), (1, 300, 130, 16)])
@pytest.mark.parametrize("block", [None, 256])
def test_plain_vs_jax_flash_and_blocked(b, n, m, c, block):
    q, k = _qk(7, b, n, m, c)
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    flash = jax_flash(jq, jk, bn=256, mt=256, interpret=True)
    with jax.default_matmul_precision("float32"):
        blocked = JF._nl_spatial_blocked(jq, jk, block=256)
    got = nl_spatial_plain(torch.from_numpy(q), torch.from_numpy(k),
                           block=block or n)
    assert got.shape == (b, n, c) and got.dtype == torch.float32
    assert _rel(got, flash) < 1e-5
    assert _rel(got, blocked) < 1e-5


def test_plain_vs_jax_blocked_bf16():
    q, k = _qk(3, 2, 2048, 96, 112)
    jq, jk = jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    want = JF._nl_spatial_blocked(jq, jk, block=512)
    got = nl_spatial_plain(torch.from_numpy(q).bfloat16(),
                           torch.from_numpy(k).bfloat16(), block=512)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want) < 2e-2


def test_passes_are_the_dense_math():
    """Pass 1 is the min and max over the whole batch (not per image);
    pass 2 with them is the dense softmax product; the CPU wrappers are the
    plain versions."""
    q, k = map(torch.from_numpy, _qk(5, 2, 333, 41, 24))
    q[1] *= 3.0                   # the images' energy ranges differ
    e = torch.einsum("bnc,bmc->bnm", q.double(), k.double())
    lohi = nl_minmax(q, k)
    np.testing.assert_allclose(lohi.numpy(), [e.min(), e.max()], rtol=1e-6)
    np.testing.assert_array_equal(lohi.numpy(),
                                  nl_minmax_plain(q, k, block=50).numpy())
    a = torch.softmax((e - e.min()) / (e.max() - e.min()), dim=-1)
    want = torch.einsum("bnm,bmc->bnc", a, k.double())
    for got in (nl_apply(q, k, lohi), nl_apply_plain(q, k, lohi, block=100),
                nl_spatial_flash(q, k)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_equal_energies_give_nan_as_jax():
    q = torch.ones(1, 10, 8)
    k = torch.ones(1, 3, 8)
    assert torch.isnan(nl_spatial_plain(q, k)).all()
    want = JF._nl_spatial_blocked(jnp.ones((1, 10, 8)), jnp.ones((1, 3, 8)),
                                  block=4)
    assert np.isnan(np.asarray(want)).all()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,err", [
    ("half", TypeError), ("mixed", TypeError), ("channels", ValueError),
    ("narrow", ValueError), ("batch", ValueError), ("rank", ValueError),
    ("not_cuda", ValueError), ("grad", RuntimeError)])
def test_wrappers_refuse(case, err):
    q, k = _meta(2, 64, 112), _meta(2, 16, 112)
    if case == "half":
        q, k = q.half(), k.half()
    elif case == "mixed":
        k = k.bfloat16()
    elif case == "channels":
        q, k = _meta(2, 64, 129), _meta(2, 16, 129)
    elif case == "narrow":        # only C = 112 is built, in either dtype
        q = _meta(2, 64, 16, dtype=torch.bfloat16)
        k = _meta(2, 16, 16, dtype=torch.bfloat16)
    elif case == "batch":
        k = _meta(1, 16, 112)
    elif case == "rank":
        q = _meta(2, 8, 8, 112)
    elif case == "grad":
        q.requires_grad_()
    lohi = _meta(2)
    for call in (lambda: nl_minmax(q, k), lambda: nl_apply(q, k, lohi),
                 lambda: nl_spatial_flash(q, k)):
        with pytest.raises(err):
            call()
