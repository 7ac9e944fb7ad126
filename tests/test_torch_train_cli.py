"""The port's train CLI on the CPU (`--device cpu`), 2 tiny epochs: the output
tree, the scalars, --resume (with --steps_per_dispatch), an interrupt, --ae
then --init_from (with --profile), the test CLI reading the checkpoint it
wrote, and the options that are not ported.
"""

import json
import os

import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.utils import tbevents as jax_tbevents
from multi_modal_image_fusion_tpu_torch.cli import test as test_cli
from multi_modal_image_fusion_tpu_torch.cli import train as train_cli
from multi_modal_image_fusion_tpu_torch.data.io import imwrite
from multi_modal_image_fusion_tpu_torch.train.checkpoint import \
    load_train_state
from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
from multi_modal_image_fusion_tpu_torch.utils import tbevents


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """5 train pairs (4 train + 1 valid after the split) and 2 test pairs,
    128x192: 6 patches each."""
    root = tmp_path_factory.mktemp("torch_train_cli")
    r = np.random.RandomState(0)
    yy, xx = np.mgrid[0:128, 0:192]
    for split, n in (("train", 5), ("test", 2)):
        for mod in ("vis", "ir"):
            os.makedirs(root / "data" / "tiny" / split / mod)
        for i in range(n):
            base = 127 + 90 * np.sin(xx / (9.0 + i)) * np.cos(yy / 13.0)
            vis = np.clip(base + r.randn(128, 192) * 10, 0, 255)
            ir = np.clip(255 - 0.6 * base + r.randn(128, 192) * 20, 0, 255)
            for mod, img in (("vis", vis), ("ir", ir)):
                imwrite(str(root / "data" / "tiny" / split / mod
                            / f"{i + 1}.png"), img.astype(np.uint8))
    return root


def _train(root, *extra):
    return train_cli.main(["--data", "tiny", "--data_root",
                           str(root / "data"), "--ckpt_root",
                           str(root / "ckpt"), "--bs", "4", "--device",
                           "cpu", *extra])


def _meta(path):
    with open(path + ".json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def run(root):
    return _train(root, "--epoch", "2", "--fast_train")


def test_output_tree_and_scalars(run):
    for name in ("train.log", "scalars.jsonl", "train/01.png",
                 "train/02.png", "valid/01.png", "valid/02.png",
                 "epoch_best.pth", "epoch_best.pth.json",
                 "epoch_best.pth.optim", "epoch_last.pth",
                 "epoch_last.pth.json", "epoch_last.pth.optim"):
        assert os.path.isfile(os.path.join(run, name)), name
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(run))
    last = os.path.join(run, "epoch_last.pth")
    assert _meta(last)["epoch"] == 2
    assert _meta(os.path.join(run, "epoch_best.pth"))["epoch"] == 2
    assert load_train_state(last)["step"] == 12       # 2 x 24 / 4
    with open(os.path.join(run, "scalars.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"lr_iter", "train_loss_iter", "valid_loss_iter",
            "train_loss_epoch", "valid_loss_epoch", "lr"} <= tags
    log = open(os.path.join(run, "train.log")).read()
    assert "train iters/epoch: 6, valid iters/epoch: 2" in log
    assert "training model done" in log


def test_tbevents_records_match_jax_copy():
    assert tbevents._scalar_event("a/b", 0.25, 7, 1.5) == \
        jax_tbevents._scalar_event("a/b", 0.25, 7, 1.5)
    assert tbevents.crc32c(b"123456789") == 0xE3069283


def test_resume_and_test_cli_read_the_checkpoint(root, run):
    name = os.path.basename(run)
    # 6 steps an epoch in train_steps calls of 4 and 2
    resumed = _train(root, "--epoch", "3", "--resume", name,
                     "--steps_per_dispatch", "4")
    log = open(os.path.join(resumed, "train.log")).read()
    assert "at epoch 2" in log and "Epoch: [03/03]" in log
    assert "Epoch: [02/03]" not in log
    last = os.path.join(resumed, "epoch_last.pth")
    assert _meta(last)["epoch"] == 3
    assert load_train_state(last)["step"] == 18
    ssim, _ = test_cli.main(["--data", "tiny", "--data_root",
                             str(root / "data"), "--ckpt_root",
                             str(root / "ckpt"), "--ckpt", name,
                             "--device", "cpu"])
    assert np.isfinite(ssim)
    assert "fps" in open(os.path.join(run, "train.log")).read()


def test_interrupt_keeps_the_last_completed_epoch(root, monkeypatch):
    orig = Trainer.train_step
    calls = []

    def interrupted(self, batch):
        calls.append(1)
        if len(calls) == 8:                  # inside epoch 2
            raise KeyboardInterrupt
        return orig(self, batch)

    monkeypatch.setattr(Trainer, "train_step", interrupted)
    before = set(os.listdir(root / "ckpt"))
    with pytest.raises(KeyboardInterrupt):
        _train(root, "--epoch", "2")
    (new,) = set(os.listdir(root / "ckpt")) - before
    last = str(root / "ckpt" / new / "epoch_last.pth")
    assert _meta(last)["epoch"] == 1
    assert load_train_state(last)["step"] == 6


def test_ae_then_init_from(root):
    ae = _train(root, "--epoch", "1", "--ae", "--bs", "2")
    assert _meta(os.path.join(ae, "epoch_last.pth"))["epoch"] == 1
    stage2 = _train(root, "--epoch", "1", "--init_from",
                    os.path.basename(ae), "--profile")
    log = open(os.path.join(stage2, "train.log")).read()
    assert "initialized params from" in log
    assert os.path.getsize(os.path.join(stage2, "profile", "trace.json"))
    got = torch.load(os.path.join(stage2, "epoch_last.pth"),
                     weights_only=True)
    assert load_train_state(os.path.join(stage2, "epoch_last.pth"))[
        "step"] == 6
    assert all(torch.isfinite(v).all() for v in got.values())


@pytest.mark.parametrize("flag", [["--spatial", "2"], ["--multihost"]])
def test_unported_options_raise(root, flag, monkeypatch):
    """--spatial > 1 is not ported (queue 1 item 7b). --multihost is
    (item 7a): without the launcher's env contract it raises naming it
    (tests/test_torch_dist_cli.py runs it with the contract)."""
    if flag == ["--multihost"]:
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            monkeypatch.delenv(key, raising=False)
        with pytest.raises(ValueError, match="RANK, WORLD_SIZE"):
            _train(root, *flag)
        return
    with pytest.raises(NotImplementedError, match="queue 1 item 7b"):
        _train(root, *flag)


def test_train_cli_without_card_raises(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--data", "tiny", "--data_root", str(root / "data"),
                        "--ckpt_root", str(root / "ckpt")])
