"""Carry of a whole JAX TrainState (params, Adam mu/nu/count, step) into the
port (utils/jax_convert.jax_train_state_to_torch), on the CPU.

Two JAX train steps, the state serialised as a JAX checkpoint stores it
(flax msgpack), carried into the port's model and Trainer; then one more
step on each side. Tolerances: parameters and moments equal after the
carry (a transpose of f32 values); after the third step, loss parts within
2e-5 and parameters within 1e-6 wherever the gradient is above 1e-4 of
its largest magnitude, as in tests/test_torch_train.py. Unused or
inconsistent leaves raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.parallel.mesh import make_mesh
from multi_modal_image_fusion_tpu.train.schedules import \
    make_lr_schedule as jax_schedule
from multi_modal_image_fusion_tpu.train.trainer import Trainer as JTrainer
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.train.schedules import \
    make_lr_schedule
from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import (
    jax_to_state_dict, jax_train_state_to_torch)


def _batch(seed):
    r = np.random.RandomState(seed)
    return (r.rand(2, 32, 32, 1).astype(np.float32),
            r.rand(2, 32, 32, 1).astype(np.float32))


@pytest.fixture(scope="module")
def jax_run():
    jt = JTrainer(jcreate("deepfuse"), jax_schedule(1e-4, 10, 12),
                  mesh=make_mesh(jax.devices()[:1]))
    state = jt.init_state(jax.random.PRNGKey(3), _batch(0))
    for i in range(2):
        state, _, _ = jt.train_step(state, tuple(map(jnp.asarray,
                                                     _batch(1 + i))))
    blob = serialization.to_bytes(jax.device_get(state))
    return jt, state, serialization.msgpack_restore(blob)


def test_train_state_carry_continues_training(jax_run):
    jt, state, restored = jax_run
    sd, opt = jax_train_state_to_torch(restored)
    assert opt["step"] == 2
    model = create_model("deepfuse")
    model.load_state_dict(sd)
    pt = Trainer(model, make_lr_schedule(1e-4, 10, 12))
    pt.load_state_dict(opt)
    adam = jax.device_get(state.opt_state[1])
    for key in ("mu", "nu"):
        want = jax_to_state_dict({"params": jax.tree.map(
            np.asarray, getattr(adam, key))})
        for k, v in getattr(pt, key).items():
            assert torch.equal(v, want[k]), (key, k)

    x = _batch(3)

    def loss(p):
        imgf = jt.model.apply({"params": p}, *map(jnp.asarray, x),
                              train=True)
        return jt.loss_bundle(*map(jnp.asarray, x), imgf)[0]
    g = jax_to_state_dict({"params": jax.tree.map(
        np.asarray, jax.grad(loss)(state.params))})
    # the JAX step donates (deletes) `state`
    jstate, jparts, _ = jt.train_step(state, tuple(map(jnp.asarray, x)))
    parts, _ = pt.train_step(tuple(map(torch.from_numpy, x)))
    for k in ("loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   atol=2e-5)
    assert pt.step == int(jstate.step) == 3
    scale = max(float(t.abs().max()) for t in g.values())
    want = jax_to_state_dict({"params": jax.tree.map(
        np.asarray, jax.device_get(jstate.params))})
    for k, v in model.state_dict().items():
        diff = (v - want[k]).abs()
        assert float(torch.where(g[k].abs() < 1e-4 * scale, 0.0,
                                 diff).max()) <= 1e-6, k
        assert float(diff.max()) <= 2e-4, k


def test_train_state_carry_fails_loudly(jax_run):
    _, _, restored = jax_run

    def variant(**change):
        out = dict(restored)
        out.update(change)
        return out
    with pytest.raises(ValueError, match="TrainState fields"):
        jax_train_state_to_torch(variant(extra=np.zeros(1)))
    opt = {k: dict(v) for k, v in restored["opt_state"].items()}
    opt["1"]["count"] = np.int32(7)
    with pytest.raises(ValueError, match="counts"):
        jax_train_state_to_torch(variant(opt_state=opt))
    opt = {k: dict(v) for k, v in restored["opt_state"].items()}
    opt["1"]["extra"] = np.zeros(1)
    with pytest.raises(ValueError, match="Adam leaves"):
        jax_train_state_to_torch(variant(opt_state=opt))
    with pytest.raises(ValueError, match="no Adam state"):
        jax_train_state_to_torch(variant(opt_state={"0": {}}))
