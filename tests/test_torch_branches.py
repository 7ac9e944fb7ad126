"""The record and replay of a forward's piecewise decisions
(train/branches.py `Decisions`, `flips`), the instrument that splits a
train step's f32 loss against float64 into branch flips and op precision
(ab_times.py --flip_split; tests/test_torch_train_card.py), on the CPU:

- each op the mode sees (relu, abs, maximum, minimum, clamp, where, max
  pool), replayed with its own record, gives the op's values and
  gradients; replayed with a decision flipped, it takes the other branch
  there and only there;
- a NestFuse train step at narrowed widths (bs 1, 32x32; max pools,
  relus, the losses' abs and maximum, SSIM's clamp): its record counts
  every op kind; replaying
  the f32 step's record in f32 gives its gradients bit for bit; the
  float64 step replaying the f32 record lies within 1e-5 of the largest
  gradient of the f32 step; the float64 step with one relu decision of
  the f32 record flipped moves the gradients (the replay takes effect);
- a replay that meets another op or shape raises;
- `excess` passes the float64 step's flips against the f32 step and names
  a kind whose flips pass FLIP_RATE of its decisions (one flip a kind is
  always allowed).
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training
from multi_modal_image_fusion_tpu_torch.train.branches import (
    FLIP_RATE, Decisions, excess, flips)
from multi_modal_image_fusion_tpu_torch.train.trainer import make_loss_bundle

OPS = {
    "relu": lambda x: torch.relu(x),
    "abs": lambda x: torch.abs(x),
    "maximum": lambda x: torch.maximum(x, x.flip(0)),
    "minimum": lambda x: torch.minimum(x, torch.zeros(())),
    "clamp": lambda x: torch.clamp(x, min=-0.5, max=0.5),
    "where": lambda x: torch.where(x >= 0, x, 0.2 * x),
    "max_pool2d": lambda x: F.max_pool2d(x.reshape(1, 2, 4, 4), 2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: these steps are small, and a loaded test run's
    workers otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(seed=0):
    x = torch.from_numpy(np.random.RandomState(seed).randn(32).astype(
        np.float32))
    x[3] = 0.0               # a tie and a kink
    return x.requires_grad_()


@pytest.mark.parametrize("kind", sorted(OPS))
def test_replay_is_the_op(kind):
    x = _x()
    want = OPS[kind](x)
    (gw,) = torch.autograd.grad(want.sum(), x)
    with Decisions() as rec:
        got = OPS[kind](x)
    assert [k for k, _ in rec.log] == [kind]
    x2 = _x()
    with Decisions(replay=rec.log):
        rep = OPS[kind](x2)
    (gr,) = torch.autograd.grad(rep.sum(), x2)
    assert torch.equal(got, want) and torch.equal(rep, want)
    assert torch.equal(gr, gw)


@pytest.mark.parametrize("kind", ["relu", "abs", "clamp", "where",
                                  "maximum"])
def test_flipped_decision_takes_the_other_branch(kind):
    x = _x()
    with Decisions() as rec:
        want = OPS[kind](x)
    (_, d), = rec.log
    i = int((x.detach() - 0.3).abs().argmin())     # a value off every kink
    bent = d.clone()
    bent[i] = (0 if d[i] else 1) if kind in ("relu", "where") else -d[i] \
        if d[i] else 1
    with Decisions(replay=[(kind, bent)]):
        got = OPS[kind](x)
    changed = (got != want).nonzero().flatten().tolist()
    assert changed == [i]


def test_replay_refuses_another_op():
    with Decisions() as rec:
        torch.relu(torch.ones(4))
    with pytest.raises(RuntimeError, match="record"):
        with Decisions(replay=rec.log):
            torch.abs(torch.ones(4))
    with pytest.raises(RuntimeError, match="record"):
        with Decisions(replay=rec.log):
            torch.relu(torch.ones(5))


def _step(model, a, b, replay=None):
    with fast_training(False), Decisions(replay) as rec:
        y = model(a, b)
        total, _ = make_loss_bundle()(a, b, y)
    grads = torch.autograd.grad(total, list(model.parameters()),
                                materialize_grads=True)
    return rec.log, [g.double() for g in grads]


def _worst(g, ref):
    big = max(float(r.abs().max()) for r in ref)
    return max(float((a - r).abs().max()) for a, r in zip(g, ref)) / big


def test_nestfuse_step_replay():
    model = create_model("nestfuse", num_ch=(8, 16, 24, 32),
                         generator=torch.Generator().manual_seed(8)).train()
    r = np.random.RandomState(0)
    a, b = (torch.from_numpy(r.rand(1, 32, 32, 1).astype(np.float32))
            for _ in range(2))
    log32, g32 = _step(copy.deepcopy(model), a, b)
    assert {k for k, _ in log32} == {"relu", "max_pool2d", "abs", "clamp",
                                     "maximum"}
    _, again = _step(copy.deepcopy(model), a, b, replay=log32)
    assert all(torch.equal(x, y) for x, y in zip(again, g32))
    m64 = copy.deepcopy(model).double()
    log64, _ = _step(copy.deepcopy(m64), a.double(), b.double())
    counts = flips(log32, log64)
    assert set(counts) == {k for k, _ in log32}
    assert all(n_diff <= n for _, n, n_diff in counts.values())
    assert excess(counts) == {}
    _, g64r = _step(copy.deepcopy(m64), a.double(), b.double(), log32)
    assert _worst(g32, g64r) <= 1e-5
    # one live relu output of a 1000+-element record switched off: the
    # replay takes it
    i = next(j for j, (k, d) in enumerate(log32)
             if k == "relu" and d.numel() > 1000 and bool(d.any()))
    bent = list(log32)
    d = bent[i][1].clone().reshape(-1)
    on = int(d.nonzero()[0])
    d[on] = 0
    bent[i] = ("relu", d.reshape(bent[i][1].shape))
    _, gbent = _step(copy.deepcopy(m64), a.double(), b.double(), bent)
    assert _worst(gbent, g64r) > 0



def test_excess_names_the_kinds_over_the_rate():
    decided = 10 ** 6
    limit = int(FLIP_RATE * decided)
    counts = {"relu": [3, decided, limit], "abs": [1, decided, limit + 1],
              "maximum": [1, 1000, 1], "clamp": [1, 1000, 2]}
    assert excess(counts) == {"abs": [1, decided, limit + 1],
                              "clamp": [1, 1000, 2]}
