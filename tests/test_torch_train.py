"""The port's training recipe (CPU) against the JAX package's.

- schedules against JAX `make_lr_schedule`, without warmup and with both
  warmups: 1e-6 relative (the JAX schedule is computed in f32, the port's
  in Python floats);
- the global-norm clip against `optax.clip_by_global_norm`, with the norm
  above 5 and below it: 1e-6 relative (f32 on both sides);
- 1 and 3 DeepFuse train steps (2 x 32 x 32 pairs, the JAX init carried
  over, plain and fast routes) against the JAX `Trainer`: loss parts
  within 2e-5 (the losses' budget), gradients within 1e-4 of the largest
  gradient magnitude (f32 convs and losses summed in other orders; a
  one-element bias gradient is a sum over every output pixel with
  cancellation, so its own relative error can pass 1e-4), parameters
  within 1e-6 absolute (1 % of the learning rate: Adam's first update is
  lr * g / (|g| + 1e-8), so a gradient's rounding hardly moves it) wherever
  the gradient is above the gradient tolerance (`_compare_step`);
- an autoencoder step and a masked valid step the same way;
- a resume round trip: 2 steps, save, resume, step 3 is bit-equal to 3
  uninterrupted steps; K chained steps equal K single ones bit for bit;
- amp bf16 keeps f32 master parameters and tracks the f32 loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.parallel.mesh import make_mesh
from multi_modal_image_fusion_tpu.train.schedules import \
    make_lr_schedule as jax_schedule
from multi_modal_image_fusion_tpu.train.trainer import Trainer as JTrainer
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training
from multi_modal_image_fusion_tpu_torch.train.checkpoint import (
    load_train_state, save_checkpoint)
from multi_modal_image_fusion_tpu_torch.train.schedules import \
    make_lr_schedule
from multi_modal_image_fusion_tpu_torch.train.trainer import (
    Trainer, clip_by_global_norm)
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict


@pytest.mark.parametrize("warmup,method", [(False, "linear"),
                                           (True, "linear"),
                                           (True, "constant")])
def test_schedule_matches_jax(warmup, method):
    kw = dict(warmup=warmup, warmup_method=method)
    js = jax_schedule(1e-4, 10, 12, **kw)
    ps = make_lr_schedule(1e-4, 10, 12, **kw)
    for step in (0, 1, 5, 9, 10, 11, 79, 80, 81, 109, 110, 200):
        np.testing.assert_allclose(ps(step), float(js(step)), rtol=1e-6)


@pytest.mark.parametrize("scale", [10.0, 0.01])
def test_clip_matches_optax(scale):
    r = np.random.RandomState(int(scale * 100))
    grads = [(r.rand(*s) - 0.5).astype(np.float32) * scale
             for s in ((16, 1, 5, 5), (16,), (1, 16, 5, 5))]
    want, _ = optax.clip_by_global_norm(5.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads))
    assert (norm > 5.0) == (scale > 1.0)
    got = clip_by_global_norm([torch.from_numpy(g) for g in grads], 5.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)


def _batch(seed, n=2, h=32, w=32):
    r = np.random.RandomState(seed)
    return (r.rand(n, h, w, 1).astype(np.float32),
            r.rand(n, h, w, 1).astype(np.float32))


def _setup(ae=False, fast=False):
    """A JAX Trainer on one CPU device and the port's Trainer on the JAX
    init's weights."""
    sched_args = (1e-4, 10, 12)
    jt = JTrainer(jcreate("deepfuse"), jax_schedule(*sched_args),
                  mesh=make_mesh(jax.devices()[:1]), ae=ae)
    x1, x2 = _batch(0)
    state = jt.init_state(jax.random.PRNGKey(0),
                          x1 if ae else (x1, x2))
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    model = create_model("deepfuse")
    model.load_state_dict(jax_to_state_dict({"params": params}))
    pt = Trainer(model, make_lr_schedule(*sched_args), ae=ae, fast=fast)
    return jt, state, pt


def _jax_grads(jt, state, x1, x2):
    tgt2 = x1 if x2 is None else x2

    def loss_fn(params):
        imgf = jt.model.apply({"params": params}, x1, x2, train=True)
        return jt.loss_bundle(x1, tgt2, imgf)[0]
    g = jax.grad(loss_fn)(state.params)
    return jax_to_state_dict({"params": jax.tree.map(np.asarray, g)})


def _port_grads(pt, x1, x2):
    with fast_training(pt.fast):
        imgf = pt.model(x1, x2)
        total, _ = pt.loss_bundle(x1, x1 if x2 is None else x2, imgf)
        grads = torch.autograd.grad(total, list(pt.params.values()))
    return dict(zip(pt.params, grads))


def _compare_step(jt, state, pt, x1, x2, loose):
    """One step on both sides. `loose` collects, per parameter, the elements
    whose gradient was ever below the gradient tolerance (1e-4 of the
    largest magnitude): there the two gradients may differ by their whole
    size, and Adam's lr * g / (|g| + 1e-8) can move those parameters apart
    by up to 2 lr a step; every other element is held to 1e-6."""
    jx2 = None if x2 is None else jnp.asarray(x2)
    tx2 = None if x2 is None else torch.from_numpy(x2)
    tx1 = torch.from_numpy(x1)
    jg = _jax_grads(jt, state, jnp.asarray(x1), jx2)
    pg = _port_grads(pt, tx1, tx2)
    scale = max(float(g.abs().max()) for g in jg.values())
    for k, g in pg.items():
        assert float((g - jg[k]).abs().max()) <= 1e-4 * scale, k
        low = jg[k].abs() < 1e-4 * scale
        loose[k] = low if k not in loose else loose[k] | low
    batch = jnp.asarray(x1) if x2 is None else (jnp.asarray(x1), jx2)
    state, jparts, _ = jt.train_step(state, batch)
    parts, imgf = pt.train_step(tx1 if x2 is None else (tx1, tx2))
    for k in ("loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   atol=2e-5)
    jp = jax_to_state_dict({"params": jax.tree.map(
        np.asarray, jax.device_get(state.params))})
    for k, v in pt.model.state_dict().items():
        diff = (v - jp[k]).abs()
        assert float(torch.where(loose[k], 0.0, diff).max()) <= 1e-6, k
        assert float(diff.max()) <= 2e-4 * pt.step, k
    assert int(state.step) == pt.step
    return state


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(steps, fast):
    jt, state, pt = _setup(fast=fast)
    loose = {}
    for i in range(steps):
        x1, x2 = _batch(10 + i)
        state = _compare_step(jt, state, pt, x1, x2, loose)


def test_ae_step_matches_jax():
    jt, state, pt = _setup(ae=True)
    _compare_step(jt, state, pt, _batch(20)[0], None, {})


def test_valid_step_mask_matches_jax():
    jt, state, pt = _setup(fast=True)
    x1, x2 = _batch(30, n=3)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    jparts, _ = jt.valid_step(state, (jnp.asarray(x1), jnp.asarray(x2)),
                              jnp.asarray(mask))
    parts, imgf = pt.valid_step((torch.from_numpy(x1), torch.from_numpy(x2)),
                                torch.from_numpy(mask))
    assert imgf.grad_fn is None
    for k in ("loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   atol=2e-5)


def _fresh(seed=0):
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(seed))
    return Trainer(model, make_lr_schedule(1e-4, 2, 3, warmup=True))


def _batches(n):
    return [tuple(map(torch.from_numpy, _batch(40 + i))) for i in range(n)]


def _state(t):
    return ({k: v.clone() for k, v in t.model.state_dict().items()},
            t.state_dict())


def _assert_equal_states(a, b):
    (ma, oa), (mb, ob) = a, b
    assert oa["step"] == ob["step"]
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for key in ("mu", "nu"):
        for k in oa[key]:
            assert torch.equal(oa[key][k], ob[key][k]), (key, k)


def test_resume_round_trip_is_bit_equal(tmp_path):
    batches = _batches(3)
    straight = _fresh()
    for b in batches:
        straight.train_step(b)

    first = _fresh()
    for b in batches[:2]:
        first.train_step(b)
    path = str(tmp_path / "epoch_last.pth")
    save_checkpoint(path, first.model.state_dict(), first.state_dict(),
                    {"epoch": 1})
    resumed = _fresh(seed=9)              # other init, all overwritten
    resumed.model.load_state_dict(torch.load(path, weights_only=True))
    resumed.load_state_dict(load_train_state(path))
    resumed.train_step(batches[2])
    _assert_equal_states(_state(resumed), _state(straight))


def test_chained_steps_equal_single_steps():
    batches = _batches(3)
    single, chained = _fresh(), _fresh()
    losses = [float(single.train_step(b)[0]["loss"]) for b in batches]
    parts, imgf = chained.train_steps(tuple(
        torch.stack([b[i] for b in batches]) for i in range(2)))
    assert parts["loss"].shape == (3,)
    assert parts["loss"].tolist() == losses
    assert imgf.shape == (2, 32, 32, 1)
    _assert_equal_states(_state(chained), _state(single))


def test_amp_bf16_trains():
    """amp='bf16' keeps f32 master parameters and moments, gives finite
    losses, and tracks the f32 recipe's loss over 5 steps (the JAX
    package's test_amp_bf16_trains bound)."""
    t32 = _fresh(1)
    t16 = _fresh(1)
    t16.amp = "bf16"
    b = tuple(map(torch.from_numpy, _batch(50, h=24, w=24)))
    for _ in range(5):
        l32 = float(t32.train_step(b)[0]["loss"])
        parts, imgf = t16.train_step(b)
        l16 = float(parts["loss"])
        assert np.isfinite(l16) and imgf.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in t16.model.parameters())
    assert all(m.dtype == torch.float32 for m in t16.mu.values())
    assert abs(l16 - l32) < 0.05 * abs(l32) + 1e-3
