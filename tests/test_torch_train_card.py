"""One train step of every model that trains, on the card, at bs 4 and
64x64: the kernels route (`fast_training(True)`: conv_valid's forward, dx
and dw for every dense k3/k5/k7 conv; Res2Fusion's 'nl' attention through
its autograd Function, nl_minmax and nl_apply forward) against the float64
F.conv2d route (the plain 'nl' attention, the Attention's plain einsums)
replaying the kernels route's piecewise decisions (train/branches.py:
activation kinks, max-pool choices, the losses' abs and maximum signs,
SSIM's clamp), train mode, each route on its own copy (chip_smoke.py's
`_step_grads`). Rounding flips a few of millions of branches between f32
and float64 (UNFusion and MAFusion: two relu outputs each at their draws),
and a flipped branch moves the gradients by its whole term: against the
plain float64 step both f32 routes missed 1e-4 there (2.31e-4 and 2.29e-4
through the kernels and F.conv2d on MAFusion's step), against the replay
of their own branches they hold 3e-7 and 6e-7 (PERF.md §6).

- the kernels route's decisions flip against the plain float64 step's at
  most FLIP_RATE (1e-5) of each kind's (train/branches.py `excess`): the
  replay would absorb the terms of any number of flips;
- loss parts within 1e-5 relative, every gradient within 1e-4 of the
  largest replayed float64 gradient (each failure names the errors against
  the plain float64 step and of the f32 F.conv2d route beside it), the new
  running statistics within 1e-5 relative; conv_valid launched exactly
  where the model has a dense k3/k5/k7 conv (the JAX gate), the nl kernels
  exactly in Res2Fusion;
- the replay's control: UNFusion's kernels route with the gradient of its
  largest-gradient weight scaled by 1 + 1e-3 misses the replay;
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
from multi_modal_image_fusion_tpu_torch.train.branches import (
    Decisions, excess, flips)
from test_torch_gray_card import cuda  # noqa: F401

BS = 4
CHECKS = {key: (name, cfg) for key, name, cfg in cs.TRAIN_CHECKS}


def _inputs(dev):
    r = np.random.RandomState(0)
    return tuple(torch.from_numpy(r.rand(BS, cs.PATCH, cs.PATCH, 1)
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))


def _live(key, dev, x1, x2):
    """(seed, model, float64 step, float64 model after it, the float64
    step's piecewise decisions) of the first weight seed from 5 whose
    float64 step is live."""
    name, cfg = CHECKS[key]
    for seed in cs.TRAIN_SEEDS:
        model = cs.train_weights(torch, cs.seeded_model(torch, name, seed,
                                                        **cfg), key).to(dev)
        f64_model = copy.deepcopy(model).double()
        rec = Decisions()
        f64 = cs._step_grads(torch, f64_model, x1.double(), x2.double(),
                             False, True, rec)
        if f64[3] > 1e-3 and max(float(g.abs().max()) for g in f64[1]) > 0:
            return seed, model, f64, f64_model, rec.log
    pytest.fail(f"{key}: no live weight seed in {cs.TRAIN_SEEDS}")


def _kernels_and_replay(model, x1, x2):
    """The kernels route's step (its piecewise decisions recorded) and the
    float64 F.conv2d step that replays them, each on its own copy."""
    rec = Decisions()
    kernels_model = copy.deepcopy(model)
    out = cs._step_grads(torch, kernels_model, x1, x2, True, False, rec)
    replay = cs._step_grads(torch, copy.deepcopy(model).double(),
                            x1.double(), x2.double(), False, True,
                            Decisions(replay=rec.log))
    return out, replay, kernels_model, rec.log


def _worst(grads, ref):
    largest = max(float(g.abs().max()) for g in ref)
    return max(float((a - c).abs().max()) for a, c in zip(grads, ref)) \
        / largest


@pytest.mark.parametrize("key", list(CHECKS))
def test_step_kernels_vs_float64(cuda, key):
    x1, x2 = _inputs(cuda)
    seed, model, (p64, g64, l64, _), f64_model, log64 = _live(key, cuda, x1,
                                                             x2)
    (pk, gk, lk, _), (_, g64r, l64r, _), kernels_model, log = \
        _kernels_and_replay(model, x1, x2)
    # the replay absorbs every flipped branch's term: bound the flips
    counts = flips(log, log64)
    assert not excess(counts), (key, "weight seed", seed, counts)
    _, gf, lf, _ = cs._step_grads(torch, copy.deepcopy(model), x1, x2, False,
                                  True)
    valid = any(isinstance(m, ConvLayer) and m._valid_eligible()
                and m.stride == 1 and not m.transpose
                for m in model.modules())
    nl = key == "res2fusion"
    assert not l64 and not lf and not l64r
    assert bool(lk.get("conv_valid/forward")) == valid, lk
    assert bool(lk.get("conv_valid_dw")) == valid, lk
    assert (lk.get("nl_minmax"), lk.get("nl_apply")) == ((2, 2) if nl
                                                         else (None, None))
    for k, v in p64.items():
        assert abs(pk[k] - v) <= 1e-5 * abs(v), (k, pk[k], v)
    largest = max(float(g.abs().max()) for g in g64r)
    plain = max(float(g.abs().max()) for g in g64)
    for (name, _), a, f, c, c0 in zip(model.named_parameters(), gk, gf, g64r,
                                      g64):
        err = float((a - c).abs().max())
        assert err <= 1e-4 * largest, (
            name, "weight seed", seed, "kernels", err / largest,
            "against plain float64", float((a - c0).abs().max()) / plain,
            "F.conv2d f32 against plain float64",
            float((f - c0).abs().max()) / plain, "of the largest", largest)
    for (n, a), c in zip(kernels_model.named_buffers(), f64_model.buffers()):
        if n.endswith(("running_mean", "running_var")):
            assert float((a.double() - c).abs().max()) <= \
                1e-5 * float(c.abs().max()), n


def test_replay_check_control_scaled_dw_misses(cuda):
    """The replay check's control: UNFusion's kernels route with the
    gradient of the weight that holds the largest one scaled by 1 + 1e-3
    misses the replayed float64 step by more than 1e-4 of its largest."""
    x1, x2 = _inputs(cuda)
    _, model, _, _, _ = _live("unfusion", cuda, x1, x2)
    (_, gk, _, _), (_, g64r, _, _), _, _ = _kernels_and_replay(model, x1,
                                                               x2)
    assert _worst(gk, g64r) <= 1e-4
    top = int(np.argmax([float(g.abs().max()) for g in gk]))
    scaled = [g * (1 + 1e-3) if i == top else g for i, g in enumerate(gk)]
    assert _worst(scaled, g64r) > 1e-4


def test_nl_backward_without_dk_misses(cuda, monkeypatch):
    """Res2Fusion's control: the Function's backward with k's gradient
    zeroed misses the float64 gradients."""
    x1, x2 = _inputs(cuda)
    _, model, (_, g64, _, _), _, _ = _live("res2fusion", cuda, x1, x2)
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
