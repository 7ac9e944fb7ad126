"""One train step of the batch-normed models IFCNN, DIFNet and PMGI
through the port's Trainer against the JAX Trainer's step (harness:
tests/test_torch_step_common.py, the JAX side in float64), plain and with
`fast=True` (their dense k3, k5 and k7 convs on conv_valid_fast's plain
versions on the CPU): the loss parts, the gradients, the parameters after the
step and the new running statistics. In train mode the encoder runs once
per modality, as the JAX package's two encoder passes do, so each
modality's batch norms see their own statistics: the control runs the
same step through one 2n batch (`batch_stats_route` forced off in the
zoo) and must miss the JAX step's new statistics (PMGI, whose two paths
are separate layers, misses by its dead transfer1[1], which the JAX
package's eager route runs and the forced-off port does not). A model
built by
create_model is in eval mode and serves as before: its training route in
eval mode (the valid step) is the serving fold's function and moves no
statistic.
"""

import numpy as np
import pytest
import torch

import test_torch_step_common as sc
from multi_modal_image_fusion_tpu_torch.models import zoo
from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training

MODELS = ("ifcnn", "difnet", "pmgi")


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_trainer_step_matches_jax(name, fast):
    sc.check_step(name, fast, trainer=True)


@pytest.mark.parametrize("name", MODELS)
def test_one_batch_misses_jax_stats(name, monkeypatch):
    """The control: the encoder over one 2n batch (the serving fold) in
    training gives other batch statistics than the JAX step's."""
    js = sc.jax_step(name, x64=True, trainer=True)
    model = sc.port_model(name, {}, js["variables"])
    monkeypatch.setattr(zoo, "batch_stats_route", lambda *a: False)
    sc.port_step(model, False)
    assert sc.stats_miss(name, {}, model, js) > 10


@pytest.mark.parametrize("name", MODELS)
def test_eval_mode_training_route_serves(name):
    """create_model's eval mode: the valid step's route (a trainer scope,
    no gradient) computes the serving function and moves nothing."""
    model = sc.port_model(name, {}, sc.variables(name))
    assert not model.training
    x1, x2 = map(torch.from_numpy, sc.batch(5))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        want = model(x1, x2)
        for fast in (False, True):
            with fast_training(fast):
                np.testing.assert_allclose(model(x1, x2).numpy(),
                                           want.numpy(), atol=1e-4)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
