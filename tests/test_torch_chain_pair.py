"""The port's fused conv pair (ops/cuda/conv_pair.py, plain version on the
CPU) against the JAX Pallas kernel `conv_tlane_chain_pair(...,
interpret=True)` (ops/pallas/conv_kernel.py:970).

The JAX side enters the C-major guard layout (`chain_enter`), runs the pair
with both halos mirrored in the kernel and leaves it (`chain_exit`), as
tests/test_pallas.py:357 does. Shapes: that test's two (8 -> 16 -> 1, k5
k5 at 24x40; 4 -> 8 -> 4, k7 k3 at 30x44) and DeepFuse's two pairs (enc0 +
enc1, 1 -> 16 -> 32, k5 k7; dec1 + dec2, 32 -> 16 -> 1, k5 k5) at an odd
size. f32 on both sides, tolerance 5e-5 (that test's).

Also: the wrappers on CPU tensors (conv_pair_enter reads the gray pair and
casts to the weights' dtype), the mid rounded to the chain dtype in bf16,
and the card check's control (the mid's halo as conv_a over the reflect-
extended input) missing by far more than the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu.ops.pallas.conv_kernel import (
    chain_enter, chain_exit, conv_tlane_chain_pair)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
    apply_act, conv_chain_plain)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_pair import (
    conv_pair_enter, conv_pair_exit, conv_pair_plain)

ATOL = 5e-5
# (h, w, c_in, c_mid, c_out, ka, kb)
CASES = {"pallas_k5k5": (24, 40, 8, 16, 1, 5, 5),
         "pallas_k7k3": (30, 44, 4, 8, 4, 7, 3),
         "deepfuse_enter": (29, 45, 1, 16, 32, 5, 7),
         "deepfuse_exit": (29, 45, 32, 16, 1, 5, 5)}


def _case(name):
    h, w, cin, cmid, cout, ka, kb = CASES[name]
    r = np.random.RandomState(sorted(CASES).index(name))
    x = r.rand(2, h, w, cin).astype(np.float32)
    wa = ((r.rand(ka, ka, cin, cmid) - 0.5) / np.sqrt(cin * ka * ka)).astype(
        np.float32)
    wb = ((r.rand(kb, kb, cmid, cout) - 0.5) / np.sqrt(cmid * kb * kb)
          ).astype(np.float32)
    ba = (r.rand(cmid) - 0.5).astype(np.float32) * 0.2
    bb = (r.rand(cout) - 0.5).astype(np.float32) * 0.2
    return x, wa, ba, wb, bb, ka, kb


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0,
                                                                  1))))


def _torch_args(wa, ba, wb, bb):
    return (_oihw(wa), torch.from_numpy(ba), "relu", _oihw(wb),
            torch.from_numpy(bb), None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_pair_vs_jax_kernel(name):
    x, wa, ba, wb, bb, ka, kb = _case(name)
    h, w = x.shape[1:3]
    yt = conv_tlane_chain_pair(chain_enter(jnp.asarray(x)), jnp.asarray(wa),
                               jnp.asarray(wb), ka, kb, h=h, w_valid=w,
                               bias_a=jnp.asarray(ba), act_a="relu",
                               bias_b=jnp.asarray(bb), act_b=None, rows=16,
                               interpret=True)
    want = np.asarray(chain_exit(yt, h, w))
    got = conv_pair_plain(torch.from_numpy(x), *_torch_args(wa, ba, wb, bb))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_wrappers_on_cpu_tensors():
    """conv_pair_enter on the gray pair (cast to the weights' dtype,
    img1's batch first) and conv_pair_exit are the plain pair."""
    x, wa, ba, wb, bb, _, _ = _case("deepfuse_enter")
    args = _torch_args(wa, ba, wb, bb)
    a, b = torch.from_numpy(x[:1]), torch.from_numpy(x[1:])
    want = conv_pair_plain(torch.from_numpy(x), *args)
    assert torch.equal(conv_pair_enter(a, b, *args), want)
    bf = [t.to(torch.bfloat16) if isinstance(t, torch.Tensor) and
          t.dim() == 4 else t for t in args]
    got = conv_pair_enter(a, b, *bf)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, conv_pair_plain(torch.from_numpy(x).to(
        torch.bfloat16), *bf))
    x, wa, ba, wb, bb, _, _ = _case("deepfuse_exit")
    args = _torch_args(wa, ba, wb, bb)
    t = torch.from_numpy(x)
    assert torch.equal(conv_pair_exit(t, *args), conv_pair_plain(t, *args))


def test_mid_is_rounded_to_the_chain_dtype():
    """In bf16 the pair is two bf16 launches: the mid is rounded to bf16
    before conv_b reads it."""
    x, wa, ba, wb, bb, _, _ = _case("deepfuse_exit")
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wa_t, ba_t, _, wb_t, bb_t, _ = _torch_args(wa, ba, wb, bb)
    mid = conv_chain_plain(xb, wa_t, ba_t, "relu")
    assert mid.dtype == torch.bfloat16
    want = conv_chain_plain(mid, wb_t, bb_t)
    got = conv_pair_plain(xb, wa_t, ba_t, "relu", wb_t, bb_t, None)
    assert torch.equal(got, want)


def _extended_mid(x, wa, ba, wb, bb, ka, kb):
    """The card check's control: conv_a over the input reflect-padded by pa
    + pb (its halo positions computed over the extended input, not
    mirrored), then conv_b VALID."""
    p = ka // 2 + kb // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (p,) * 4, mode="reflect")
    mid = apply_act(F.conv2d(xp, wa, ba), "relu")
    return F.conv2d(mid, wb, bb).permute(0, 2, 3, 1)


@pytest.mark.parametrize("name", ["deepfuse_enter", "deepfuse_exit"])
def test_card_control_misses(name):
    x, wa, ba, wb, bb, ka, kb = _case(name)
    args = _torch_args(wa, ba, wb, bb)
    xt = torch.from_numpy(x)
    want = conv_pair_plain(xt, *args)
    ctl = _extended_mid(xt, args[0], args[1], args[3], args[4], ka, kb)
    assert float((ctl - want).abs().max()) > 1e-2 * float(want.abs().max())
