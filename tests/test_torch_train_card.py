"""One train step of every model that trains, on the card, at bs 4 and
64x64: the kernels route (`fast_training(True)`: conv_valid's forward, dx
and dw for every dense k3/k5/k7 conv; Res2Fusion's 'nl' attention through
its autograd Function, nl_minmax and nl_apply forward) against the float64
F.conv2d route (the plain 'nl' attention, the Attention's plain einsums),
train mode, each route on its own copy (chip_smoke.py's `_step_grads`):

- loss parts within 1e-5 relative, every gradient within 1e-4 of the
  largest float64 gradient (each failure names the f32 F.conv2d route's
  error on the same step beside the kernels'), the new running statistics
  within 1e-5 relative; conv_valid launched exactly where the model has a
  dense k3/k5/k7 conv (the JAX gate), the nl kernels exactly in Res2Fusion;
- Res2Fusion's control: the Function's backward with k's gradient zeroed
  must miss the float64 gradients (near-uniform attention weights, as
  Res2Fusion's features give, put most of the Function's gradient on k).

Inputs: two batches of uniform images from numpy seed 0. Weights:
chip_smoke.py's `seeded_model` (MyFusion's MetaFormer configurations with
its `train_weights` kernel scales) at the first seed from 5 whose float64
step is live (fused image std above 1e-3, a non-zero gradient); no
condition on any f32 route.

Needs a CUDA device and nvcc; every test skips without a card. Run on the
GPU machine from the checkout's root with (the JAX-importing conftest is
skipped):

    python -m pytest --noconftest tests/test_torch_train_card.py
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import \
    NLSpatialFlash
from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer
from test_torch_gray_card import cuda  # noqa: F401

BS = 4
CHECKS = {key: (name, cfg) for key, name, cfg in cs.TRAIN_CHECKS}


def _inputs(dev):
    r = np.random.RandomState(0)
    return tuple(torch.from_numpy(r.rand(BS, cs.PATCH, cs.PATCH, 1)
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))


def _live(key, dev, x1, x2):
    """(seed, model, float64 step, float64 model after it) of the first
    weight seed from 5 whose float64 step is live."""
    name, cfg = CHECKS[key]
    for seed in cs.TRAIN_SEEDS:
        model = cs.train_weights(torch, cs.seeded_model(torch, name, seed,
                                                        **cfg), key).to(dev)
        f64_model = copy.deepcopy(model).double()
        f64 = cs._step_grads(torch, f64_model, x1.double(), x2.double(),
                             False, True)
        if f64[3] > 1e-3 and max(float(g.abs().max()) for g in f64[1]) > 0:
            return seed, model, f64, f64_model
    pytest.fail(f"{key}: no live weight seed in {cs.TRAIN_SEEDS}")


@pytest.mark.parametrize("key", list(CHECKS))
def test_step_kernels_vs_float64(cuda, key):
    x1, x2 = _inputs(cuda)
    seed, model, (p64, g64, l64, _), f64_model = _live(key, cuda, x1, x2)
    kernels_model = copy.deepcopy(model)
    pk, gk, lk, _ = cs._step_grads(torch, kernels_model, x1, x2, True, False)
    _, gf, lf, _ = cs._step_grads(torch, copy.deepcopy(model), x1, x2, False,
                                  True)
    valid = any(isinstance(m, ConvLayer) and m._valid_eligible()
                and m.stride == 1 and not m.transpose
                for m in model.modules())
    nl = key == "res2fusion"
    assert not l64 and not lf
    assert bool(lk.get("conv_valid/forward")) == valid, lk
    assert bool(lk.get("conv_valid_dw")) == valid, lk
    assert (lk.get("nl_minmax"), lk.get("nl_apply")) == ((2, 2) if nl
                                                         else (None, None))
    for k, v in p64.items():
        assert abs(pk[k] - v) <= 1e-5 * abs(v), (k, pk[k], v)
    largest = max(float(g.abs().max()) for g in g64)
    for (name, _), a, f, c in zip(model.named_parameters(), gk, gf, g64):
        err = float((a - c).abs().max())
        assert err <= 1e-4 * largest, (
            name, "weight seed", seed, "kernels", err / largest,
            "F.conv2d f32",
            float((f - c).abs().max()) / largest, "of the largest", largest)
    for (n, a), c in zip(kernels_model.named_buffers(), f64_model.buffers()):
        if n.endswith(("running_mean", "running_var")):
            assert float((a.double() - c).abs().max()) <= \
                1e-5 * float(c.abs().max()), n


def test_nl_backward_without_dk_misses(cuda, monkeypatch):
    """Res2Fusion's control: the Function's backward with k's gradient
    zeroed misses the float64 gradients."""
    x1, x2 = _inputs(cuda)
    _, model, (_, g64, _, _), _ = _live("res2fusion", cuda, x1, x2)
    backward = NLSpatialFlash.backward

    def no_dk(ctx, g):
        dq, dk = backward(ctx, g)
        return dq, torch.zeros_like(dk)
    monkeypatch.setattr(NLSpatialFlash, "backward", staticmethod(no_dk))
    _, gk, lk, _ = cs._step_grads(torch, copy.deepcopy(model), x1, x2, True,
                                  False)
    assert lk.get("nl_apply") == 2
    largest = max(float(g.abs().max()) for g in g64)
    worst = max(float((a - c).abs().max()) for a, c in zip(gk, g64))
    assert worst > 1e-4 * largest
