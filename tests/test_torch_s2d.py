"""The port's space-to-depth packing (ops/s2d.py), the plain packed conv of
conv_wide's s2d mode and the plain s2d_enter / s2d_exit against the JAX
package, on the CPU.

- s2d_pack, s2d_unpack and s2d_pack_bias equal the JAX module's bit for
  bit; s2d_pack_weights (OIHW) equals the JAX packed HWIO kernel,
  transposed, for k1-k7 at f 2 and 4;
- the plain packed conv (conv_wide(..., s2d_f=2) on CPU tensors: the
  per-phase reflect extension, F.conv2d with the packed weight) equals the
  reflect-SAME conv at 1e-5, alone and chained (tests/test_s2d.py:51, :85);
- the plain s2d_enter and s2d_exit equal JAX s2d_chain_enter and
  s2d_chain_exit (ops/pallas/s2d_io.py) in interpret mode on the valid
  region, bf16, bit for bit;
- the switches read the environment as the JAX package reads it;
- the card checks' controls (the phase-blind reflect halo; a pack with the
  px phases swapped) miss the packed conv and the pack by far more than
  their tolerances, so they can fail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.ops import s2d as J
from multi_modal_image_fusion_tpu.ops.pallas.conv_kernel import (
    CHAIN_GUARD, CHAIN_WG)
from multi_modal_image_fusion_tpu.ops.pallas.s2d_io import (
    s2d_chain_enter, s2d_chain_exit)
from multi_modal_image_fusion_tpu.ops.pallas.s2d_io import \
    s2d_io_ok as jax_s2d_io_ok
from multi_modal_image_fusion_tpu_torch.ops import s2d as P
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
    conv_chain_plain
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_wide import conv_wide
from multi_modal_image_fusion_tpu_torch.ops.cuda.s2d_io import (
    s2d_enter, s2d_exit)


def _np(t):
    return t.detach().float().numpy()


def test_pack_unpack_bias_equal_jax():
    r = np.random.RandomState(0)
    x = r.rand(2, 8, 12, 3).astype(np.float32)
    for f in (2, 4):
        got = P.s2d_pack(torch.from_numpy(x), f)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(J.s2d_pack(jnp.asarray(x),
                                                            f)))
        np.testing.assert_array_equal(
            P.s2d_unpack(got, f).numpy(),
            np.asarray(J.s2d_unpack(J.s2d_pack(jnp.asarray(x), f), f)))
        np.testing.assert_array_equal(P.s2d_unpack(got, f).numpy(), x)
    b = r.rand(5).astype(np.float32)
    np.testing.assert_array_equal(P.s2d_pack_bias(torch.from_numpy(b)).numpy(),
                                  np.asarray(J.s2d_pack_bias(jnp.asarray(b))))


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("f", [2, 4])
def test_pack_weights_equal_jax(k, f):
    r = np.random.RandomState(k + f)
    w = (r.rand(k, k, 3, 5) - 0.5).astype(np.float32)          # HWIO
    want = np.transpose(np.asarray(J.s2d_pack_weights(jnp.asarray(w), f)),
                        (3, 2, 0, 1))
    got = P.s2d_pack_weights(torch.from_numpy(
        np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))), f)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert P.s2d_span(k, f) == got.shape[-1]
    assert P.s2d_flop_overhead(k, f) == J.s2d_flop_overhead(k, f)


def _oihw(r, k, cin, cout):
    return torch.from_numpy((r.rand(cout, cin, k, k) - 0.5).astype(
        np.float32))


def _packed_conv(x, w, b=None, act=None, fuse_n=0):
    """The packed conv through conv_wide's s2d mode (plain on the CPU)."""
    bp = None if b is None else P.s2d_pack_bias(b)
    y = conv_wide([(P.s2d_pack(x), 0)], P.s2d_pack_weights(w), bp, act,
                  fuse_n, s2d_f=2)
    return P.s2d_unpack(y)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("cin,cout", [(1, 16), (16, 32), (32, 32), (16, 1)])
def test_plain_packed_conv_equals_reflect_same(k, cin, cout):
    r = np.random.RandomState(k * 10 + cin + cout)
    x = torch.from_numpy((r.rand(2, 16, 24, cin) - 0.5).astype(np.float32))
    w = _oihw(r, k, cin, cout)
    b = torch.from_numpy((r.rand(cout) - 0.5).astype(np.float32))
    want = conv_chain_plain(x, w, b, "relu")
    np.testing.assert_allclose(_np(_packed_conv(x, w, b, "relu")),
                               _np(want), rtol=1e-5, atol=1e-5)


def test_plain_packed_conv_fuse_n_and_odd_packed_height():
    """fuse_n sums the packed halves; packed height 15 (30 rows) reaches
    the bottom mirror of both phases."""
    r = np.random.RandomState(3)
    x = torch.from_numpy((r.rand(4, 30, 44, 32) - 0.5).astype(np.float32))
    w = _oihw(r, 7, 32, 32)
    want = conv_chain_plain(x, w, None, None, fuse_n=2)
    np.testing.assert_allclose(_np(_packed_conv(x, w, fuse_n=2)), _np(want),
                               rtol=1e-5, atol=1e-5)


def test_chained_packed_convs_equal_chained_reflect_same():
    r = np.random.RandomState(7)
    x = torch.from_numpy((r.rand(1, 12, 16, 4) - 0.5).astype(np.float32))
    w1, w2 = _oihw(r, 5, 4, 8), _oihw(r, 7, 8, 4)
    want = conv_chain_plain(conv_chain_plain(x, w1), w2)
    y = conv_wide([(P.s2d_pack(x), 0)], P.s2d_pack_weights(w1), s2d_f=2)
    y = conv_wide([(y, 0)], P.s2d_pack_weights(w2), s2d_f=2)
    np.testing.assert_allclose(_np(P.s2d_unpack(y)), _np(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("p", [1, 2])
def test_reflect_pad_is_the_packed_pad_of_the_image(p):
    r = np.random.RandomState(p)
    x = torch.from_numpy(r.rand(2, 10, 14, 3).astype(np.float32))
    xo = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (2 * p,) * 4,
                                 mode="reflect").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(
        P.s2d_reflect_pad(P.s2d_pack(x), p).numpy(), P.s2d_pack(xo).numpy())


@pytest.mark.parametrize("h,w", [(40, 256), (32, 256)])
def test_plain_enter_exit_equal_jax_kernels(h, w):
    """Rows 13-14 in interpret mode, valid region, bf16, bit for bit. h=40:
    the JAX kernel's 4-row tail path; h=32: aligned."""
    r = np.random.RandomState(7)
    x1 = (r.rand(3, h, w, 1) - 0.5).astype(np.float32)
    x2 = (r.rand(3, h, w, 1) - 0.5).astype(np.float32)
    xj = jnp.asarray(np.concatenate([x1, x2]), jnp.bfloat16)
    jt = s2d_chain_enter(xj, interpret=True)
    h2, w2 = h // 2, w // 2
    want = np.transpose(np.asarray(
        jt[:, :, CHAIN_GUARD:CHAIN_GUARD + h2,
           CHAIN_WG:CHAIN_WG + w2].astype(jnp.float32)), (0, 2, 3, 1))
    a, b = (torch.from_numpy(v).to(torch.bfloat16) for v in (x1, x2))
    got = s2d_enter(a, b, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (6, h2, w2, 4)
    np.testing.assert_array_equal(_np(got), want)
    back = s2d_exit(got)
    np.testing.assert_array_equal(
        _np(back), np.asarray(s2d_chain_exit(jt, h, w, interpret=True)
                              .astype(jnp.float32)))
    np.testing.assert_array_equal(_np(back), _np(torch.cat([a, b])))


def test_enter_casts_to_the_chain_dtype():
    r = np.random.RandomState(8)
    a, b = (torch.from_numpy(r.rand(2, 6, 8, 1).astype(np.float32))
            for _ in range(2))
    got = s2d_enter(a, b, torch.bfloat16)
    want = P.s2d_pack(torch.cat([a, b]).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(s2d_enter(a, b, torch.float32),
                       P.s2d_pack(torch.cat([a, b])))


def test_switches_read_the_environment(monkeypatch):
    for key in ("MMIF_S2D", "MMIF_S2D_IO", "MMIF_CHAIN_HIW",
                "MMIF_CHAIN_PAIR"):
        monkeypatch.delenv(key, raising=False)
    assert not P.s2d_enabled() and not P.s2d_io_enabled()
    assert P.hiw_enabled() and not P.chain_pair_enabled()
    for v, on in (("1", True), ("0", False), ("auto", False)):
        monkeypatch.setenv("MMIF_S2D", v)
        monkeypatch.setenv("MMIF_S2D_IO", v)
        assert P.s2d_enabled() is on and P.s2d_io_enabled() is on
        assert J.s2d_enabled() is on and J.s2d_io_enabled() is on
    monkeypatch.setenv("MMIF_CHAIN_HIW", "0")
    assert not P.hiw_enabled()
    for v in ("1", "0", "yes"):                # any non-empty value is on
        monkeypatch.setenv("MMIF_CHAIN_PAIR", v)
        assert P.chain_pair_enabled()
    monkeypatch.setenv("MMIF_CHAIN_PAIR", "")
    assert not P.chain_pair_enabled()
    for h, w in ((1224, 1024), (1226, 1024), (1224, 640), (24, 256),
                 (32, 256)):
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                        (torch.float32, jnp.float32)):
            assert P.s2d_io_ok(h, w, dt) == jax_s2d_io_ok(h, w, jdt)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_card_controls_miss():
    """The card checks' controls: the packed conv with the phase-blind
    reflect of the packed tensor (conv_wide without s2d mode), and a pack
    with the px phases swapped, miss by far more than the 1e-3 bf16
    tolerance."""
    r = np.random.RandomState(9)
    for k, cin, cout in ((5, 1, 16), (7, 16, 32), (5, 16, 1)):
        x = torch.from_numpy((r.rand(2, 30, 44, cin) - 0.5).astype(
            np.float32))
        w = _oihw(r, k, cin, cout)
        xp, wp = P.s2d_pack(x), P.s2d_pack_weights(w)
        want = conv_wide([(xp, 0)], wp, s2d_f=2)
        blind = conv_wide([(xp, 0)], wp)
        assert _rel(blind, want) > 1e-2
    a, b = (torch.from_numpy(r.rand(2, 8, 12, 1).astype(np.float32))
            for _ in range(2))
    packed = s2d_enter(a, b, torch.float32)
    swapped = packed[..., [1, 0, 3, 2]]
    assert _rel(swapped, packed) > 1e-2


def test_deepfuse_io_route_is_bit_identical_on_bf16(monkeypatch):
    """MMIF_S2D_IO=1 swaps only the packed chain's entry and exit (the JAX
    package's tests/test_s2d_io.py:62): at an eligible bf16 shape the
    forward is bit-identical to the torch-pack glue's, and s2d_enter and
    s2d_exit ran."""
    from multi_modal_image_fusion_tpu_torch.models import create_model, zoo
    monkeypatch.setenv("MMIF_S2D", "1")
    monkeypatch.setenv("MMIF_CHAIN_HIW", "0")
    calls = {"s2d_enter": 0, "s2d_exit": 0}
    for name in calls:
        fn = getattr(zoo, name)

        def spy(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(zoo, name, spy)
    model = create_model("deepfuse", generator=torch.Generator().manual_seed(
        0)).to(torch.bfloat16).eval()
    r = np.random.RandomState(5)
    x1, x2 = (torch.from_numpy(r.rand(1, 32, 256, 1).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2))
    with torch.no_grad():
        monkeypatch.setenv("MMIF_S2D_IO", "0")
        want = model(x1, x2)
        monkeypatch.setenv("MMIF_S2D_IO", "1")
        got = model(x1, x2)
    assert calls == {"s2d_enter": 1, "s2d_exit": 1}
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
