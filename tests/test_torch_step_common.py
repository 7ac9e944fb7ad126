"""Shared harness of the port's train-step tests against the JAX package
(tests/test_torch_train_{norms,zoo,nest,myfusion,nl}.py,
tests/test_torch_bn_train.py). It holds no test itself.

One train step of a model on one batch: 2 pairs of 32x32 uniform images
from a numpy seed. The weights are a JAX variables tree whose shapes come
from `jax.eval_shape` of the model's init (no init compile: the jitted
init took 3-12 s a model on one CPU, the eval_shape 0.1-1.2 s), filled from a
numpy seed by test_torch_myfusion.seeded_tree: Kaiming-normal kernels
(|w| under the modules named `live`, so that a relu end stays live), conv
biases, norm shifts and batch means within +-0.1, norm scales in [0.5,
1.5], running variances in [0.5, 2]; carried into the port by
utils/jax_convert.jax_to_state_dict.

The JAX side is one jit a model and file (`jax_step`, cached; compiled
with XLA's backend optimisations at level 0 in f32, 1 in float64, which
cut the compile by a half and a sixth): jax.grad
of the JAX Trainer's loss (`Trainer._train_step_impl`: its
`_apply(train=True)` with the batch statistics mutable, its loss bundle)
and, with `trainer`, its optax chain's update: the gradients, the loss
parts and the fused image, and the new batch statistics and parameters
after the update. The port side is its Trainer's `train_step` (train
mode), the gradients caught where the step hands them to its update
(`port_step`).

The batch-normed models are held against the JAX step in float64
(`x64`): flax's BatchNorm takes its f32 variance as E[x^2] - E[x]^2
(use_fast_variance), and on IFCNN's step that put the JAX f32 gradients
1.2e-4 of the largest from float64 (1.4e-6 with the two-pass variance),
the port's f32 ones 7.8e-8 (ops/layers.batch_norm: `var_mean`, centred).
So is Res2Fusion: the JAX f32 gradients of its step lie up to 6.9e-4 of
the largest from float64 (from decode.0, the first layer after the 'nl'
attention fusion, down), the port's f32 ones 6.4e-7.

Tolerances (`check_step`): the loss parts within 2e-5; every gradient
within 1e-4 of the largest gradient magnitude of the JAX step; with
`trainer` (the batch-normed models) also the parameters after the step
within 1e-6 where the gradient is above that tolerance and within 2 lr
below it (Adam's first step moves a parameter by lr * g / (|g| + eps):
a gradient that is rounding noise, as a conv bias under a batch norm
has, moves by up to lr either way), and the running statistics within
1e-5 of max(1, their largest magnitude).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import test_torch_myfusion as mf
from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.parallel.mesh import make_mesh
from multi_modal_image_fusion_tpu.train.schedules import \
    make_lr_schedule as jax_schedule
from multi_modal_image_fusion_tpu.train.trainer import Trainer as JTrainer
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.train.schedules import \
    make_lr_schedule
from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

SCHED = (1e-4, 10, 12)
LR = SCHED[0]
GRAD_TOL = 1e-4
PARTS_ATOL = 2e-5
PARAM_ATOL = 1e-6
STATS_TOL = 1e-5
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def batch(seed=13, n=2, hw=(32, 32)):
    r = np.random.RandomState(seed)
    return tuple(r.rand(n, *hw, 1).astype(np.float32) for _ in range(2))


def _key(cfg):
    return json.dumps(cfg, sort_keys=True)


@functools.lru_cache(maxsize=None)
def _variables(name, cfg_key, seed, live, scales):
    jm = jcreate(name, **json.loads(cfg_key))
    x = jax.ShapeDtypeStruct((1, 32, 32, 1), jnp.float32)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.PRNGKey(0), x, x)
    shapes = {k: shapes[k] for k in ("params", "batch_stats") if k in shapes}
    v = mf.seeded_tree(shapes, seed, live=live)
    if not scales:
        return v
    down, other = scales

    def scale(path, a):
        keys = [p.key for p in path]
        if keys[-1] != "kernel" or keys[1].startswith("conv_"):
            return a
        return np.abs(a) * down if keys[1].startswith("down") else a * other
    return jax.tree_util.tree_map_with_path(scale, v)


def variables(name, cfg=None, seed=0, live=(), scales=None):
    """The seeded JAX variables {"params", ["batch_stats"]} of `name` with
    `cfg` (numpy, cached; a fresh copy of the dicts each call). `scales`
    (down, other), for MyFusion: the TransitionBlocks' kernels |w| x down,
    the other kernels but conv_in's and conv_out's w x other."""
    v = _variables(name, _key(cfg or {}), seed, tuple(live),
                   scales and tuple(scales))
    return jax.tree.map(np.array, v)


def to_port(name, cfg, tree, stats):
    """A JAX params-shaped tree (params, gradients) -> the port's parameter
    names (the batch statistics `stats` only let the carry pass through
    the norms; their buffers are left out)."""
    sd = jax_to_state_dict({"params": tree, "batch_stats": stats}, name,
                           **(_layout(name, cfg)))
    return {k: v for k, v in sd.items()
            if k.rsplit(".", 1)[-1] not in _BUFFERS}


def _layout(name, cfg):
    return (create_model(name, **cfg).layout_cfg if name == "myfusion"
            else {})


@functools.lru_cache(maxsize=None)
def _jax_step(name, cfg_key, seed, live, data_seed, x64, scales, trainer):
    cfg = json.loads(cfg_key)
    v = variables(name, cfg, seed, live, scales)
    jt = JTrainer(jcreate(name, **cfg), jax_schedule(*SCHED),
                  mesh=make_mesh(jax.devices()[:1]))
    dt = np.float64 if x64 else np.float32

    def step(params, stats, x1, x2):
        def loss_fn(p):
            imgf, new_stats = jt._apply(p, stats, x1, x2, train=True)
            total, parts = jt.loss_bundle(x1, x2, imgf)
            return total, (parts, new_stats, imgf)
        grads, (parts, new_stats, imgf) = jax.grad(
            loss_fn, has_aux=True)(params)
        out = {"grads": grads, "parts": parts, "imgf": imgf}
        if trainer:
            updates, _ = jt.tx.update(grads, jt.tx.init(params), params)
            out.update(stats=new_stats,
                       after=optax.apply_updates(params, updates))
        return out
    with jax.enable_x64(x64):
        params, stats = (jax.tree.map(lambda a: np.asarray(a, dt),
                                      v.get(k, {}))
                         for k in ("params", "batch_stats"))
        args = (params, stats, *(a.astype(dt) for a in batch(data_seed)))
        # XLA's backend optimisations: off in f32 (half the compile, the
        # run's library convs as they were); level 1 in float64, whose
        # convs are generated code that level 0 ran 12x slower
        opts = {"xla_backend_optimization_level": 1 if x64 else 0}
        fn = jax.jit(step).lower(*args).compile(compiler_options=opts)
        out = jax.tree.map(np.asarray, jax.device_get(fn(*args)))
    out["parts"] = {k: float(p) for k, p in out["parts"].items()}
    return {"variables": v, **out}


def jax_step(name, cfg=None, seed=0, live=(), data_seed=13, x64=False,
             scales=None, trainer=False):
    """The JAX step on `batch(data_seed)` from `variables(name, cfg, seed,
    live, scales)`, one jit (cached), in float64 with `x64`: {"variables",
    "grads" (JAX tree), "parts", "imgf"} and with `trainer` the Trainer's
    update too: "after" (params after it), "stats" (the new batch
    statistics)."""
    return _jax_step(name, _key(cfg or {}), seed, tuple(live), data_seed,
                     x64, scales and tuple(scales), trainer)


def port_model(name, cfg, v):
    model = create_model(name, **cfg)
    model.load_state_dict(jax_to_state_dict(v, name, **_layout(name, cfg)))
    return model


def port_step(model, fast, data_seed=13):
    """One step of the port's Trainer (train mode, `fast`) on
    `batch(data_seed)`: (loss parts, {name: gradient} as the step hands
    them to its update, fused output). The model is updated in place."""
    pt = Trainer(model, make_lr_schedule(*SCHED), fast=fast)
    seen = {}
    update = pt._update

    def spy(grads):
        seen.update(zip(pt.params, (g.detach().clone() for g in grads)))
        return update(grads)
    pt._update = spy
    x1, x2 = map(torch.from_numpy, batch(data_seed))
    threads = torch.get_num_threads()
    # one thread: these steps are small, and a loaded test run's workers
    # otherwise oversubscribe the cores (a 0.3 s step took 30 s)
    torch.set_num_threads(1)
    try:
        parts, imgf = pt.train_step((x1, x2))
    finally:
        torch.set_num_threads(threads)
    assert pt.step == 1 and not model.training
    return {k: float(v) for k, v in parts.items()}, seen, imgf


def check_step(name, fast, cfg=None, seed=0, live=(), trainer=False,
               x64=None, scales=None):
    """The port's step against the JAX step (module docstring); returns
    (port model after the step, JAX step) for further checks. The fused
    image is live and the largest gradient non-zero, so the check cannot
    hold vacuously."""
    cfg = cfg or {}
    js = jax_step(name, cfg, seed, live, x64=trainer if x64 is None else x64,
                  scales=scales, trainer=trainer)
    v = js["variables"]
    model = port_model(name, cfg, v)
    parts, grads, imgf = port_step(model, fast)
    assert js["imgf"].std() > 1e-3, js["imgf"].std()
    for k in ("loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(parts[k], js["parts"][k], atol=PARTS_ATOL,
                                   err_msg=k)
    stats = v.get("batch_stats", {})
    jg = to_port(name, cfg, js["grads"], stats)
    assert sorted(grads) == sorted(jg)
    scale = max(float(g.abs().max()) for g in jg.values())
    assert scale > 0
    for k, g in grads.items():
        err = float((g - jg[k]).abs().max())
        assert err <= GRAD_TOL * scale, (k, err, scale)
    if trainer:
        check_after(name, cfg, model, js, jg, scale)
    return model, js


def check_after(name, cfg, model, js, jg, scale):
    """The parameters after the step and the new running statistics
    against the JAX Trainer step's (module docstring)."""
    want = jax_to_state_dict({"params": js["after"],
                              "batch_stats": js["stats"]}, name,
                             **_layout(name, cfg))
    sd = model.state_dict()
    assert sorted(sd) == sorted(want)
    n_stats = 0
    for k, v in sd.items():
        kind = k.rsplit(".", 1)[-1]
        if kind == "num_batches_tracked":
            continue
        diff = (v - want[k]).abs()
        if kind in _BUFFERS:
            n_stats += 1
            bound = STATS_TOL * max(1.0, float(want[k].abs().max()))
            assert float(diff.max()) <= bound, (k, float(diff.max()))
            continue
        loose = jg[k].abs() < GRAD_TOL * scale
        assert float(torch.where(loose, 0.0, diff).max()) <= PARAM_ATOL, k
        assert float(diff.max()) <= 2 * LR, k
    assert n_stats > 0


def stats_miss(name, cfg, model, js):
    """The largest difference of the port model's running statistics from
    the JAX step's new ones, over STATS_TOL x max(1, their magnitude): a
    control step must give more than 1."""
    want = jax_to_state_dict({"params": js["after"],
                              "batch_stats": js["stats"]}, name,
                             **_layout(name, cfg))
    worst = 0.0
    for k, v in model.state_dict().items():
        if k.rsplit(".", 1)[-1] in ("running_mean", "running_var"):
            bound = STATS_TOL * max(1.0, float(want[k].abs().max()))
            worst = max(worst, float((v - want[k]).abs().max()) / bound)
    return worst
