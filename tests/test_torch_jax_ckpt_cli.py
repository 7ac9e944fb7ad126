"""The port's CLIs on a JAX package checkpoint folder (the committed IFCNN
run, tests/torch_fixtures/ifcnn_jax: epoch_last.ckpt and its .json), on
the CPU:

- the test CLI (`--device cpu`) fuses every pair of a tiny dataset within
  1e-4 of the JAX model's forward with the checkpoint's variables (flax's
  own msgpack_restore), eval mode, the same images;
- the train CLI's `--resume` (`cli/train.resume`) loads the whole
  TrainState: the next port step equals `jax_train_state_to_torch`
  followed by one step (tests/test_torch_train_state.py), and its loss
  parts are the JAX Trainer's next step's within 2e-5;
- `--init_from` (`restore` through `checkpoint_path`) takes the
  parameters and statistics alone.
"""

import os
import shutil

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
from multi_modal_image_fusion_tpu_torch.cli import test as test_cli
from multi_modal_image_fusion_tpu_torch.cli import train as train_cli
from multi_modal_image_fusion_tpu_torch.data.dataset import FusionDataset
from multi_modal_image_fusion_tpu_torch.data.io import imwrite
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.train import checkpoint as ckpt
from multi_modal_image_fusion_tpu_torch.train.schedules import \
    make_lr_schedule
from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_train_state_to_torch

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "ifcnn_jax")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: these steps are small, and a loaded test run's
    workers otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _restored():
    with open(os.path.join(FIXTURE, "epoch_last.ckpt"), "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_ckpt_cli")
    data = root / "datasets" / "tinyset"
    rng = np.random.RandomState(4)
    for mod in ("vis", "ir"):
        os.makedirs(data / "test" / mod)
    for i, (h, w) in enumerate([(40, 56), (33, 47)]):
        base = (rng.rand(h, w) * 255).astype(np.uint8)
        imwrite(str(data / "test" / "vis" / f"{i + 1}.png"), base)
        imwrite(str(data / "test" / "ir" / f"{i + 1}.png"),
                (rng.rand(h, w) * 255).astype(np.uint8))
    shutil.copytree(FIXTURE, root / "ckpts" / "run")
    return root


def test_test_cli_on_jax_checkpoint(setup, monkeypatch):
    fused = []
    keep = test_cli.save_result

    def spy(img):
        fused.append(img.copy())
        return keep(img)
    monkeypatch.setattr(test_cli, "save_result", spy)
    ssim, _ = test_cli.main(["--data", "tinyset", "--data_root",
                             str(setup / "datasets"), "--ckpt_root",
                             str(setup / "ckpts"), "--ckpt", "run",
                             "--device", "cpu"])
    assert np.isfinite(ssim) and len(fused) == 2
    restored = _restored()
    variables = {k: restored[k] for k in ("params", "batch_stats")}
    jm = jcreate("ifcnn")
    ds = FusionDataset(str(setup / "datasets" / "tinyset"), set_name="test",
                       set_type="test", img_type="ir")
    for i, got in enumerate(fused):
        a, b = (jnp.asarray(v)[None, ..., None] for v in ds[i])
        with jax.default_matmul_precision("float32"):
            want = np.asarray(jm.apply(variables, a, b, train=False))[0]
        assert want.std() > 1e-3
        np.testing.assert_allclose(got, want, atol=1e-4)


def _batch(seed):
    r = np.random.RandomState(seed)
    return (r.rand(2, 32, 32, 1).astype(np.float32),
            r.rand(2, 32, 32, 1).astype(np.float32))


def test_resume_from_jax_checkpoint():
    model = create_model("ifcnn")
    trainer = Trainer(model, make_lr_schedule(1e-4, 10, 12))
    path, epoch = train_cli.resume(FIXTURE, model, trainer, "ifcnn")
    assert path.endswith("epoch_last.ckpt") and epoch == 1
    assert trainer.step == 1
    sd, opt = jax_train_state_to_torch(ckpt.to_numpy_tree(_restored()),
                                       "ifcnn")
    ref = create_model("ifcnn")
    ref.load_state_dict(sd)
    ref_trainer = Trainer(ref, make_lr_schedule(1e-4, 10, 12))
    ref_trainer.load_state_dict(opt)
    x = tuple(map(torch.from_numpy, _batch(7)))
    parts, _ = trainer.train_step(x)
    ref_parts, _ = ref_trainer.train_step(x)
    for k in parts:
        assert float(parts[k]) == float(ref_parts[k]), k
    for (k, v), w in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        assert torch.equal(v, w), k
    # the JAX Trainer's next step from the same checkpoint
    jt = JTrainer(jcreate("ifcnn"), jax_schedule(1e-4, 10, 12),
                  mesh=make_mesh(jax.devices()[:1]))
    template = jt.init_state(jax.random.PRNGKey(0), tuple(
        map(jnp.asarray, _batch(0))))
    with open(os.path.join(FIXTURE, "epoch_last.ckpt"), "rb") as f:
        state = serialization.from_bytes(jax.device_get(template), f.read())
    _, jparts, _ = jt.train_step(state, tuple(map(jnp.asarray, _batch(7))))
    for k in ("loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   atol=2e-5)


def test_init_from_jax_checkpoint_takes_params_only():
    model = create_model("ifcnn")
    trainer = Trainer(model, make_lr_schedule(1e-4, 10, 12))
    path = ckpt.checkpoint_path(FIXTURE)
    assert ckpt.restore(model, path, "ifcnn") == ([], [])
    assert trainer.step == 0
    assert all(float(t.abs().max()) == 0.0 for t in trainer.mu.values())
