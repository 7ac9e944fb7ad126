"""The port's VALID conv and its autograd function (CPU: the plain versions)
against the JAX package's kernels in interpret mode.

- `conv_valid_plain` (bias + activation) against
  `ops/pallas/conv_kernel.py:161 conv_tlane_dma(..., interpret=True)` at k
  3/5/7, c_in 1/8, c_out 1/16/24: 1e-4 absolute (f32 on both sides; the
  Pallas kernel sums the k*k*c_in products in another order, and the inputs
  keep the outputs below ~10, where f32 rounding of a 392-term sum is
  ~1e-6);
- `conv_valid_fast`'s output and gradients against JAX `conv_valid_fast`
  (`ops/pallas/conv_vjp.py:71`, interpret mode) through the same
  nonlinear objective as tests/test_conv_vjp.py: 1e-4 relative to the
  largest value (f32; dx is a 7x7xC full correlation and dw a sum over
  2x24x40 pixels, whose rounding stays ~1e-6 of the largest value);
- `torch.autograd.gradcheck` of conv_valid_fast in float64;
- in a DeepFuse train step under `fast_training`, exactly 5 forward and 4
  dx conv_valid calls (enc0's input carries no gradient), and 5 fused calls
  in a valid step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.ops.pallas.conv_kernel import \
    conv_tlane_dma
from multi_modal_image_fusion_tpu.ops.pallas.conv_vjp import \
    conv_valid_fast as jax_conv_valid_fast
from multi_modal_image_fusion_tpu_torch.ops.cuda import conv_vjp
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_valid import (
    conv_valid, conv_valid_plain)
from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_vjp import \
    conv_valid_fast

ACTS = ("relu", None, "lrelu", "tanh", "relu6", "relu")


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize("cout", [1, 16, 24])
@pytest.mark.parametrize("cin", [1, 8])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_conv_valid_plain_matches_pallas(k, cin, cout):
    r = np.random.RandomState(k * 100 + cin * 10 + cout)
    act = ACTS[(k + cin + cout) % len(ACTS)]
    xp = (r.rand(2, 11 + k - 1, 19 + k - 1, cin) - 0.5).astype(np.float32)
    w = ((r.rand(k, k, cin, cout) - 0.5) * 0.5).astype(np.float32)
    b = (r.rand(cout) - 0.5).astype(np.float32)
    want = np.asarray(conv_tlane_dma(jnp.asarray(xp), jnp.asarray(w), k,
                                     bias=jnp.asarray(b), act=act,
                                     interpret=True))
    got = conv_valid(torch.from_numpy(xp), _oihw(w), torch.from_numpy(b),
                     act)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("k,cin,cout", [(3, 16, 16), (5, 8, 24), (7, 32, 1),
                                        (5, 1, 16)])
def test_conv_valid_fast_grads_match_jax(k, cin, cout):
    r = np.random.RandomState(0)
    h, wd = 24, 40
    xp = (r.rand(2, h + k - 1, wd + k - 1, cin) - 0.5).astype(np.float32)
    w = (r.rand(k, k, cin, cout) - 0.5).astype(np.float32)
    cot = r.rand(2, h, wd, cout).astype(np.float32)

    def obj(xp, w):
        return (jnp.tanh(jax_conv_valid_fast(xp, w, k, True)) * cot).sum()
    y_j = np.asarray(jax_conv_valid_fast(jnp.asarray(xp), jnp.asarray(w), k,
                                         True))
    gx_j, gw_j = (np.asarray(g) for g in jax.grad(obj, argnums=(0, 1))(
        jnp.asarray(xp), jnp.asarray(w)))

    xt = torch.from_numpy(xp).requires_grad_()
    wt = _oihw(w).requires_grad_()
    y = conv_valid_fast(xt, wt)
    (torch.tanh(y) * torch.from_numpy(cot)).sum().backward()
    gw = wt.grad.permute(2, 3, 1, 0).numpy()           # OIHW -> HWIO
    for got, want in ((y.detach().numpy(), y_j), (xt.grad.numpy(), gx_j),
                      (gw, gw_j)):
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-4 * scale


def test_conv_valid_fast_gradcheck():
    r = np.random.RandomState(1)
    xp = torch.from_numpy(r.rand(1, 6, 7, 2)).requires_grad_()
    w = torch.from_numpy(r.rand(3, 2, 5, 5) - 0.5).requires_grad_()
    assert torch.autograd.gradcheck(conv_valid_fast, (xp, w))
    # only the weight needs a gradient: dx is skipped
    xp_const = xp.detach()
    assert torch.autograd.gradcheck(lambda w: conv_valid_fast(xp_const, w),
                                    (w,))


def test_deepfuse_step_launch_plan(monkeypatch):
    """Under fast_training a DeepFuse train step calls the conv kernel 9
    times (5 forward, 4 dx) and a valid step 5 times (bias+act fused): the
    counts chip_smoke.py asserts on the card."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops import layers
    from multi_modal_image_fusion_tpu_torch.train.schedules import \
        make_lr_schedule
    from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer

    calls = []

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls.append(kw.get("site", name))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(conv_vjp, "conv_valid",
                        counting("?", conv_vjp.conv_valid))
    monkeypatch.setattr(layers, "conv_valid", counting("valid", conv_valid))
    r = np.random.RandomState(2)
    batch = tuple(torch.from_numpy(r.rand(2, 20, 24, 1).astype(np.float32))
                  for _ in range(2))
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, make_lr_schedule(1e-4, 10, 12), fast=True)
    trainer.train_step(batch)
    assert sorted(calls) == ["dx"] * 4 + ["forward"] * 5
    calls.clear()
    trainer.valid_step(batch)
    assert calls == ["valid"] * 5
    calls.clear()
    Trainer(model, make_lr_schedule(1e-4, 10, 12)).train_step(batch)
    assert calls == []


def test_conv_valid_plain_dtypes():
    """float64 stays float64 (gradcheck); bf16 is computed in f32 and cast
    back."""
    r = np.random.RandomState(3)
    xp = torch.from_numpy(r.rand(1, 8, 8, 2))
    w = torch.from_numpy(r.rand(3, 2, 5, 5))
    assert conv_valid_plain(xp, w).dtype == torch.float64
    y16 = conv_valid_plain(xp.bfloat16(), w.bfloat16())
    assert y16.dtype == torch.bfloat16
    want = conv_valid_plain(xp.bfloat16().float(), w.bfloat16().float())
    assert torch.equal(y16, want.bfloat16())
