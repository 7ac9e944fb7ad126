"""The piecewise decisions of a forward, recorded in one run and replayed in
another: which branch each activation's kink, each max-pool window, each
`torch.abs` and `torch.maximum` / `torch.minimum` of the losses and each
clamp took. A train step in f32 and the same step in float64 round their
values differently, and where a value lies within rounding of a kink the
two take different branches: a relu mask, a pooled pixel or an L1 term's
sign flips, and the gradients differ by that branch's whole term. Replaying
one route's decisions in another route's arithmetic separates those flips
from the precision of the ops between them.

    with Decisions() as rec:            # record
        y = model(a, b); loss = ...
    with Decisions(replay=rec.log):     # the same ops, rec's branches
        y64 = model64(a64, b64); loss64 = ...
    counts = flips(rec.log, other.log)  # where two records disagree
    over = excess(counts)               # kinds that flip too often

The mode sees the torch functions the port's forward calls (a
TorchFunctionMode): `torch.relu`, `torch.abs`, `torch.maximum`,
`torch.minimum`, `torch.clamp`, `torch.where` (three arguments: lrelu's
kink) and `F.max_pool2d`. A recorded decision is an int8 or int64 tensor
beside its kind; a replayed op computes the same function of its inputs
with the recorded branch (a relu as x * mask, |x| as x * sign, a max pool
as a gather at the recorded indices, a maximum's tie as the mean, which
is torch's gradient there), so its gradient follows the recorded branch.
A replayed step absorbs the whole term of every flipped branch, so a check
against a replay also bounds the flips themselves (`excess`, FLIP_RATE).
Backward passes are not recorded: open the mode around the forward and the
loss only. Both runs must call the ops in the same order on tensors of the
same shapes; a replay that meets another op or shape raises.
"""

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["Decisions", "FLIP_RATE", "excess", "flips"]

# the share of a kind's decisions that f32 rounding may flip against
# float64: UNFusion's and MAFusion's train steps (bs 4, 64x64) flip 2 of
# 10.3 M and 2 of 17.4 M relu outputs, 1 of 2.2 M abs signs
FLIP_RATE = 1e-5

_KINDS = {torch.relu: "relu", torch.Tensor.relu: "relu", F.relu: "relu",
          torch.abs: "abs", torch.Tensor.abs: "abs",
          torch.maximum: "maximum", torch.minimum: "minimum",
          torch.clamp: "clamp", torch.Tensor.clamp: "clamp",
          torch.where: "where", F.max_pool2d: "max_pool2d"}


def _tensor(v, like):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, dtype=like.dtype, device=like.device)


def _clamp_bounds(args, kwargs):
    lo = args[1] if len(args) > 1 else kwargs.get("min")
    hi = args[2] if len(args) > 2 else kwargs.get("max")
    return lo, hi


def _decide(kind, args, kwargs):
    """(the op's output, its decision) for a recorded call."""
    x = args[0]
    if kind == "relu":
        return torch.relu(x), (x > 0).to(torch.int8)
    if kind == "abs":
        return torch.abs(x), torch.sign(x).to(torch.int8)
    if kind in ("maximum", "minimum"):
        a, b = x, args[1]
        out = (torch.maximum if kind == "maximum" else torch.minimum)(a, b)
        return out, torch.sign(a - b).to(torch.int8)
    if kind == "clamp":
        lo, hi = _clamp_bounds(args, kwargs)
        d = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
        if lo is not None:
            d = torch.where(x < lo, -1, d).to(torch.int8)
        if hi is not None:
            d = torch.where(x > hi, 1, d).to(torch.int8)
        return torch.clamp(x, lo, hi), d
    if kind == "where":
        cond, a, b = args
        return torch.where(cond, a, b), cond.to(torch.int8)
    if kind == "max_pool2d":
        out, idx = F.max_pool2d(*args, **{**kwargs, "return_indices": True})
        return out, idx
    raise AssertionError(kind)


def _replay(kind, d, args, kwargs):
    """The op of `kind` on this call's inputs with the recorded branch d."""
    x = args[0]
    if kind == "relu":
        return x * d.to(x.dtype)
    if kind == "abs":
        return x * d.to(x.dtype)
    if kind in ("maximum", "minimum"):
        a, b = x, _tensor(args[1], x)
        first, second = (a, b) if kind == "maximum" else (b, a)
        return torch.where(d > 0, first, torch.where(d < 0, second,
                                                     (a + b) * 0.5))
    if kind == "clamp":
        lo, hi = _clamp_bounds(args, kwargs)
        out = x
        if hi is not None:
            out = torch.where(d > 0, _tensor(hi, x), out)
        if lo is not None:
            out = torch.where(d < 0, _tensor(lo, x), out)
        return out
    if kind == "where":
        _, a, b = args
        return torch.where(d.bool(), a, b)
    if kind == "max_pool2d":
        n, c = x.shape[:2]
        return x.reshape(n, c, -1).gather(2, d.reshape(n, c, -1)).reshape(
            d.shape)
    raise AssertionError(kind)


class Decisions(TorchFunctionMode):
    """Record (`replay` None) or replay (`replay` a `log` of another run)
    the piecewise decisions of the ops the mode sees (module docstring).
    `log` is the list of (kind, decision) in call order."""

    def __init__(self, replay=None):
        super().__init__()
        self.replay = replay
        self.log = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _KINDS.get(func)
        if kind == "where" and len(args) + len(kwargs) != 3:
            kind = None
        if kind == "max_pool2d" and kwargs.get("return_indices"):
            kind = None
        if kind is None or not isinstance(args[0], torch.Tensor):
            return func(*args, **kwargs)
        i = len(self.log)
        if self.replay is None:
            out, d = _decide(kind, args, kwargs)
            self.log.append((kind, d))
            return out
        if i >= len(self.replay):
            raise RuntimeError(f"replay: call {i} ({kind}) past the record's "
                               f"{len(self.replay)}")
        rkind, d = self.replay[i]
        out = func(*args, **kwargs)
        if rkind != kind or d.shape != out.shape and kind != "where" or (
                kind == "where" and d.shape != args[0].shape):
            raise RuntimeError(f"replay: call {i} is {kind} {tuple(out.shape)}"
                               f", the record's {rkind} {tuple(d.shape)}")
        self.log.append((kind, d))
        return _replay(kind, d, args, kwargs)


def flips(log_a, log_b):
    """{kind: [calls, elements decided, elements that differ]} between two
    records of the same forward."""
    if [k for k, _ in log_a] != [k for k, _ in log_b]:
        raise ValueError("the two records called different ops")
    out = {}
    for (kind, a), (_, b) in zip(log_a, log_b):
        row = out.setdefault(kind, [0, 0, 0])
        row[0] += 1
        row[1] += a.numel()
        row[2] += int((a != b.to(a.device)).sum())
    return out


def excess(counts):
    """The kinds of a `flips` count whose differing elements exceed
    FLIP_RATE of the elements decided, or one element where that is less
    than one: {kind: [calls, decided, differ]}."""
    return {k: row for k, row in counts.items()
            if row[2] > max(1.0, FLIP_RATE * row[1])}
