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
- `nl_apply_flash_plain`, the TPU kernel's rounding of pass 2 (the bf16
  kernel's function), against JAX `nl_spatial_flash` in interpret mode in
  bf16;
- `pack_keys` / `unpack_keys`, the bf16 kernels' key layout: the index map
  of csrc/nl_attention.cu's header, zeros past the last key, an exact
  round trip;
- the wrappers' refusals, on tensors that are not on the CPU (meta
  tensors: the checks run before any launch);
- `nl_variants`' edits of csrc/nl_attention.cu still find their places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.ops import fusion as JF
from multi_modal_image_fusion_tpu.ops.pallas.nl_kernel import \
    nl_spatial_flash as jax_flash
from multi_modal_image_fusion_tpu_torch import nl_variants
from multi_modal_image_fusion_tpu_torch.ops.cuda import build
from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
    KEY_TILE, nl_apply, nl_apply_flash_plain, nl_apply_plain, nl_minmax,
    nl_minmax_plain, nl_spatial_flash, nl_spatial_plain, pack_keys,
    unpack_keys)


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


def test_flash_rounding_plain_vs_jax_flash_bf16():
    """nl_apply_flash_plain rounds as the TPU kernel does (the unnormalised
    weights to bf16, the row sums in f32): against JAX nl_spatial_flash in
    interpret mode, bf16 in and out, within 1e-2 of the largest attention
    term |out - mean(k)| (one bf16 rounding of the output, 2^-8 of it, and
    f32 sums in another order). nl_apply_plain, which rounds the normalised
    weights, is the other function, further from it."""
    r = np.random.RandomState(11)
    q = (r.rand(2, 700, 112) * 2 - 1).astype(np.float32)
    k = r.rand(2, 90, 112).astype(np.float32) * 2 - 1
    k -= k.mean(1, keepdims=True)
    jq, jk = jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    want = np.asarray(jax_flash(jq, jk, bn=256, mt=256, interpret=True),
                      np.float32)
    tq, tk = torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16()
    lohi = nl_minmax_plain(tq, tk)
    got = nl_apply_flash_plain(tq, tk, lohi, block=256)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    scale = float(np.abs(want - tk.float().mean(1, keepdim=True).numpy())
                  .max())
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 1e-2 * scale, (err, scale)
    other = nl_apply_plain(tq, tk, lohi, block=256).float().numpy()
    assert float(np.abs(other - want).max()) > err


@pytest.mark.parametrize("m", [1, 8, 63, KEY_TILE, 70, 3 * KEY_TILE + 17])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pack_keys_layout(m, dtype):
    """packed[b, m // 8, c // 8, m % 8, c % 8] = k[b, m, c], keys zero up
    to a multiple of KEY_TILE, each tile KEY_TILE * C contiguous values;
    unpack_keys gives k back exactly."""
    k = torch.from_numpy(np.random.RandomState(m).randn(2, m, 112)
                         .astype(np.float32)).to(dtype)
    kp = pack_keys(k)
    mp = -(-m // KEY_TILE) * KEY_TILE
    assert kp.shape == (2, mp // 8, 14, 8, 8) and kp.is_contiguous()
    assert kp.dtype == dtype
    flat = kp.reshape(2, -1)
    for b, key, c in [(0, 0, 0), (1, m - 1, 111), (0, m // 2, 37),
                      (1, m // 3, 8), (0, m - 1, 7)]:
        want = k[b, key, c]
        assert kp[b, key // 8, c // 8, key % 8, c % 8] == want
        off = (key // 8) * 14 * 64 + (c // 8) * 64 + (key % 8) * 8 + c % 8
        assert flat[b, off] == want
    assert (unpack_keys(kp, mp)[:, m:] == 0).all()
    assert torch.equal(unpack_keys(kp, m), k)


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


def test_nl_variants_edit_the_source():
    """Each design variant that nl_variants times is the committed source
    with its one edit applied: none equals the source, and the ring and
    overlap variants change only the lines they name."""
    src = (build.CSRC / "nl_attention.cu").read_text()
    vs = nl_variants.variants(src)
    assert vs.pop("committed") == src
    assert sorted(vs) == ["apply_no_overlap", "no_turns", "ring2", "ring3",
                          "ring6", "ring8"]
    for name, text in vs.items():
        assert text != src, name
    assert "constexpr int NL_STAGES = 6;" in vs["ring6"]
    assert "named_bar_sync(me" not in vs["no_turns"]
    assert "named_bar_sync(3" in vs["no_turns"]
    assert vs["apply_no_overlap"].count("wgmma_wait<1>();") == \
        src.count("wgmma_wait<1>();") - 1
