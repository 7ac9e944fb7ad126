"""One MyFusion train step through the port's Trainer against the JAX
step (harness: tests/test_torch_step_common.py) in three configurations:
the default (sep encoder, nest decoder, 'sca' fusion; no dense k3, k5 or
k7 conv, so `fast=True` takes the same routes and only the plain step
runs), mixformer_ls_concat and transformer_fs_elem (the reference
goldens' two; MetaFormer blocks with batch norms: the whole Trainer step
against the JAX package's in float64, the new running statistics too;
mixformer_ls_concat's concat fusion convs are k3, so also `fast=True`).

Weights (seeded, test_torch_step_common.variables): conv_in's and
conv_out's kernels |w| (so the relu6 entry and exit stay live); for the
MetaFormer configurations the TransitionBlocks' kernels |w| / 4 and, in
the transformer, the other blocks' kernels halved. At plain Kaiming-normal
draws some batch-norm input channels are constant over the batch (a relu6
dead or saturated everywhere), whose gradient is the difference of terms
1/sqrt(eps) = 316 times larger, a level; the port's own f32 gradients
then lay 1.5e-2 (transformer) to 4e8 (mixformer) of the largest from its
float64 ones, so no f32 comparison could hold. `test_no_constant_channel`
checks that no batch-norm input channel of these draws is constant.

Each configuration's JAX step compiles once (its first case); the
one-2n-batch control (every level shared in transformer_fs_elem) must
miss the JAX step's new statistics.
"""

import jax
import pytest
import torch

import chip_smoke
import test_torch_step_common as sc
from multi_modal_image_fusion_tpu_torch.models import zoo
from multi_modal_image_fusion_tpu_torch.ops import layers

NAME = "myfusion"
LIVE_IN = ("conv_out", "conv_in_1", "conv_in_2")


def _former(key, **kw):
    """A MetaFormer configuration of chip_smoke.py (MYF_FORMERS) with its
    kernel scales (FORMER_TRAIN_SCALES), as the card's step check takes
    them."""
    key = f"myfusion_{key}"
    return (chip_smoke.MYF_FORMERS[key],
            dict(live=LIVE_IN, scales=chip_smoke.FORMER_TRAIN_SCALES[key],
                 trainer=True, **kw))


# case: (configuration, check_step keywords)
CASES = {
    "default": ({}, dict(live=("conv_out", "conv_in_1", "down1_1"))),
    "mixformer_ls_concat": _former("mixformer_ls_concat"),
    "transformer_fs_elem": _former("transformer_fs_elem", seed=2),
}
FAST = ("mixformer_ls_concat",)


def _jax(case):
    cfg, kw = CASES[case]
    kw = dict(kw)
    trainer = kw.pop("trainer", False)
    return cfg, kw, sc.jax_step(NAME, cfg, x64=trainer, trainer=trainer,
                                **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_step_is_live(case):
    """The JAX step (compiled here, once a configuration): a live fused
    image and a non-zero gradient."""
    _, _, js = _jax(case)
    assert js["imgf"].std() > 1e-2
    assert max(float(abs(g).max()) for g in jax.tree.leaves(js["grads"])) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_constant_channel(case, monkeypatch):
    """No batch norm of the step sees a constant input channel."""
    cfg, kw, js = _jax(case)
    model = sc.port_model(NAME, cfg, js["variables"])
    worst = []
    real = layers.batch_norm

    def spy(x, bn, act=None, batch_stats=False):
        worst.append(float(x.detach().var(dim=(0, 1, 2)).min()))
        return real(x, bn, act, batch_stats)
    monkeypatch.setattr(layers, "batch_norm", spy)
    sc.port_step(model, False)
    if kw.get("trainer"):
        assert worst and min(worst) > 1e-5, min(worst)


@pytest.mark.parametrize("case,fast", [(c, False) for c in sorted(CASES)]
                         + [(c, True) for c in FAST])
def test_step_matches_jax(case, fast):
    cfg, kw = CASES[case]
    sc.check_step(NAME, fast, cfg, **kw)


def test_one_batch_misses_jax_stats(monkeypatch):
    cfg, kw, js = _jax("transformer_fs_elem")
    model = sc.port_model(NAME, cfg, js["variables"])
    monkeypatch.setattr(zoo, "batch_stats_route", lambda *a: False)
    sc.port_step(model, False)
    assert sc.stats_miss(NAME, cfg, model, js) > 10
