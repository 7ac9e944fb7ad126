"""Data parallelism of the port on the CPU (parallel/mesh.py, the Trainer's
collectives, the batch norms' global statistics): two gloo ranks, spawned
once for the module by chip_smoke.run_ranks (the card's phase "parallel"
runs the same worker, `dist_rank`), each stepping on its half of a global
batch of 4 pairs of 32x32 images.

- DeepFuse (no norm, through the conv_valid route's plain versions) and
  IFCNN (batch norms; on F.conv2d and through the conv_valid route's
  plain versions) against the one-process step on the same 4 images:
  loss within 1e-6, the averaged gradients within 1e-5 of the largest
  gradient, the parameters after the update within 1e-5 (JAX
  tests/test_parallel.py:29-50) where their gradient passes 1e-5 of the
  largest and within 2 lr where it is rounding noise (a conv bias under
  a batch norm: Adam's first step moves it by up to lr either way; the
  rule of tests/test_torch_step_common.py), the running statistics
  within 1e-5 of their largest magnitude (chip_smoke.dist_within); both
  ranks' parameters equal.
- IFCNN's 2-rank step against the JAX Trainer's on a 2-device CPU mesh
  (the batch sharded, XLA's SPMD partitioner inserting the reductions), in
  float64 on the JAX side (flax's f32 E[x^2] - E[x]^2 variance puts its
  own f32 gradients 1.2e-4 of the largest from float64,
  tests/test_torch_step_common.py): gradients, new batch statistics and
  loss within 1e-4.
- Controls that must miss by 10x: the gradient all-reduce removed
  (DeepFuse), each rank's batch statistics its own (IFCNN).
- The helpers without a process group: no collective, nothing changes.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_torch_step_common as sc
from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.parallel.mesh import (make_mesh,
                                                        replicate,
                                                        shard_batch)
from multi_modal_image_fusion_tpu.train.schedules import \
    make_lr_schedule as jax_schedule
from multi_modal_image_fusion_tpu.train.trainer import Trainer as JTrainer
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.parallel import mesh

BS, HW = 4, 32
# key -> (model, --fast_train, control): the card's phase "parallel"
# runs the same cases
CASES = {key: (name, fast, ctl) for key, name, fast, ctl in cs.DIST_CASES}


def _batch():
    r = np.random.RandomState(3)
    return tuple(r.rand(BS, HW, HW, 1).astype(np.float32) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _states():
    """The DeepFuse weights of a seeded init and IFCNN's carried from the
    seeded JAX variables of the step harness (live batch-norm scales and
    statistics)."""
    deepfuse = create_model("deepfuse",
                            generator=torch.Generator().manual_seed(0))
    ifcnn = sc.port_model("ifcnn", {}, sc.variables("ifcnn"))
    return {"deepfuse": deepfuse.state_dict(), "ifcnn": ifcnn.state_dict()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{case: [rank 0's record, rank 1's]} of one 2-rank run."""
    root = str(tmp_path_factory.mktemp("torch_dist"))
    x1, x2 = _batch()
    np.savez(os.path.join(root, "batch.npz"), x1=x1, x2=x2)
    for name, state in _states().items():
        torch.save(state, os.path.join(root, f"{name}.pth"))
    cases = [{"key": key, "model": name, "fast": fast,
              "state": os.path.join(root, f"{name}.pth"),
              **({"control": ctl} if ctl else {})}
             for key, (name, fast, ctl) in CASES.items()]
    cs.run_ranks({"out": root, "device": "cpu",
                  "batch": os.path.join(root, "batch.npz"), "cases": cases},
                 timeout=240)
    return {key: [torch.load(os.path.join(root, f"{key}.rank{r}.pt"),
                             weights_only=True) for r in range(2)]
            for key in CASES}


@functools.lru_cache(maxsize=None)
def _one_process(name, fast):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cs.one_rank_step(torch, name, _states()[name], fast, *_batch(),
                                torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("key", ["deepfuse", "ifcnn", "ifcnn_fast"])
def test_two_ranks_match_one_process(ranks, key):
    name, fast, _ = CASES[key]
    want = _one_process(name, fast)
    for got in ranks[key]:
        err = cs.dist_errors(got, want)
        assert cs.dist_within(err), err
    a, b = (r["params"] for r in ranks[key])
    assert all(torch.equal(a[n], b[n]) for n in a)
    if name == "ifcnn":
        assert want["buffers"] and all(
            torch.equal(ranks[key][0]["buffers"][n], v)
            for n, v in ranks[key][1]["buffers"].items())


@pytest.mark.parametrize("key", ["deepfuse_no_grad_sync",
                                 "ifcnn_local_stats"])
def test_controls_miss(ranks, key):
    name, fast, _ = CASES[key]
    want = _one_process(name, fast)
    for got in ranks[key]:
        assert cs.dist_missed_by(cs.dist_errors(got, want)), key


def test_ifcnn_two_ranks_match_jax_mesh(ranks):
    """The JAX Trainer's loss and batch-statistic update (its `_apply`
    with the statistics mutable, its loss bundle) under jit on a 2-device
    mesh, the batch sharded over it, float64."""
    v = sc.variables("ifcnn")
    jt = JTrainer(jcreate("ifcnn"), jax_schedule(*cs.DIST_SCHED),
                  mesh=make_mesh(jax.devices()[:2]))

    def step(params, stats, x1, x2):
        def loss_fn(p):
            imgf, new_stats = jt._apply(p, stats, x1, x2, train=True)
            total, parts = jt.loss_bundle(x1, x2, imgf)
            return total, (parts, new_stats)
        return jax.grad(loss_fn, has_aux=True)(params)
    with jax.enable_x64(True):
        params, stats = (replicate(jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64), v[k]), jt.mesh)
            for k in ("params", "batch_stats"))
        x1, x2 = shard_batch(tuple(a.astype(np.float64) for a in _batch()),
                             jt.mesh)
        assert len(x1.addressable_shards) == 2
        grads, (parts, new_stats) = jax.device_get(
            jax.jit(step)(params, stats, x1, x2))
    want_g = sc.to_port("ifcnn", {}, grads, v["batch_stats"])
    sd = sc.port_model("ifcnn", {}, {"params": v["params"],
                                     "batch_stats": new_stats}).state_dict()
    gmax = max(float(g.abs().max()) for g in want_g.values())
    for got in ranks["ifcnn"]:
        assert abs(got["parts"]["loss"] - float(parts["loss"])) <= 1e-4
        for n, g in want_g.items():
            np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(),
                                       atol=1e-4 * gmax, rtol=0)
        for n, b in got["buffers"].items():
            np.testing.assert_allclose(b.numpy(), sd[n].numpy(), atol=1e-4,
                                       rtol=0)


def test_helpers_without_group_are_identity():
    assert not torch.distributed.is_initialized()
    assert mesh.world_size() == 1 and mesh.rank() == 0
    assert mesh.is_main_process()
    ts = [torch.ones(3), torch.zeros(())]
    out = mesh.all_reduce_mean(ts)
    assert all(a is b for a, b in zip(out, ts))
    t = torch.arange(4.0)
    assert mesh.global_sum(t) is t
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(mesh.shard_batch(x), x)
    np.testing.assert_array_equal(mesh.shard_batch(x, 1, 3), x[2:4])
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(x, 0, 4)


def test_world1_group_runs_no_collective(monkeypatch):
    """A world-1 gloo group reduces nothing (mesh.spans_ranks): the helpers
    stay the identity and call no collective, and DeepFuse's and IFCNN's
    Trainer steps in the group equal the steps without one bit for bit."""
    import torch.distributed as dist
    want = {name: _one_process(name, False) for name in _states()}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{cs.free_port()}", rank=0, world_size=1)
    try:
        def refuse(*args, **kwargs):
            raise AssertionError("a collective ran in a world-1 group")
        for op in ("all_reduce", "broadcast"):
            monkeypatch.setattr(dist, op, refuse)
        assert mesh.world_size() == 1 and not mesh.spans_ranks()
        ts = [torch.ones(3)]
        assert mesh.all_reduce_mean(ts)[0] is ts[0]
        assert mesh.global_sum(ts[0]) is ts[0]
        mesh.broadcast_module(torch.nn.Linear(2, 2))
        _one_process.cache_clear()
        got = {name: _one_process(name, False) for name in _states()}
    finally:
        _one_process.cache_clear()
        dist.destroy_process_group()
    for name, w in want.items():
        for k in ("grads", "params", "buffers"):
            assert all(torch.equal(got[name][k][n], v)
                       for n, v in w[k].items()), (name, k)
        assert got[name]["parts"] == w["parts"]


def test_feeder_shards_and_wrap_pads():
    """Each rank places its contiguous slice of the global batch; a final
    partial batch is wrap-padded to a multiple of the world size, the
    repeats masked out, n_true the global count."""
    from multi_modal_image_fusion_tpu_torch.data.pipeline import Feeder
    ds = [(np.full((2, 2), i, np.float32), np.full((2, 2), -i, np.float32))
          for i in range(5)]
    got = {r: [(b[0][:, 0, 0, 0].tolist(), m.tolist(), n) for b, m, n in
               Feeder(ds, 4, with_mask=True, shard=(r, 2))]
           for r in range(2)}
    assert got[0] == [([0.0, 1.0], [1.0, 1.0], 4), ([4.0], [1.0], 1)]
    assert got[1] == [([2.0, 3.0], [1.0, 1.0], 4), ([4.0], [0.0], 1)]
