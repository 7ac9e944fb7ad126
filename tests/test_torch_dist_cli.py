"""The port's CLIs with data parallelism and height tiling on the CPU:

- two processes of the train CLI with `--multihost --device cpu` under the
  launcher's env contract (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT),
  one epoch on a tiny seeded dataset (global batch 4): only rank 0 writes
  under --ckpt_root, and its checkpoint's parameters equal a one-process
  run's within 1e-5;
- `--bs 3` on 2 ranks raises with both numbers, before any rank joins;
- the test CLI with `--tiles 2` on a height that needs padding notes it
  once and gives the SSIM of the untiled CLI on the same padded input
  (`--pad_bucket 16`) within 1e-6; `--spatial 2` raises naming queue 1
  item 7b, `--spatial 1` is off.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from multi_modal_image_fusion_tpu_torch.cli import test as test_cli
from multi_modal_image_fusion_tpu_torch.cli import train as train_cli
from multi_modal_image_fusion_tpu_torch.data.io import imwrite
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.train.checkpoint import \
    save_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """5 train pairs of 64x128 (4 train + 1 valid after the split: 8 and 2
    patches) and 2 test pairs of 40x48; a seeded DeepFuse checkpoint."""
    root = tmp_path_factory.mktemp("torch_dist_cli")
    r = np.random.RandomState(0)
    for split, n, (h, w) in (("train", 5, (64, 128)), ("test", 2, (40, 48))):
        yy, xx = np.mgrid[0:h, 0:w]
        for mod in ("vis", "ir"):
            os.makedirs(root / "data" / "tiny" / split / mod)
        for i in range(n):
            base = 127 + 90 * np.sin(xx / (7.0 + i)) * np.cos(yy / 11.0)
            vis = np.clip(base + r.randn(h, w) * 10, 0, 255)
            ir = np.clip(255 - 0.6 * base + r.randn(h, w) * 20, 0, 255)
            for mod, img in (("vis", vis), ("ir", ir)):
                imwrite(str(root / "data" / "tiny" / split / mod
                            / f"{i + 1}.png"), img.astype(np.uint8))
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(4))
    save_state_dict(str(root / "ckpt_test" / "run" / "epoch_best.pth"),
                    model.state_dict(), meta={"model": "deepfuse"})
    return root


def _train_args(root, ckpt, *extra):
    return ["--data", "tiny", "--data_root", str(root / "data"),
            "--ckpt_root", str(root / ckpt), "--bs", "4", "--epoch", "1",
            "--device", "cpu", "--fast_train", *extra]


@pytest.fixture(scope="module")
def runs(root):
    """The run folders under --ckpt_root of the 2-rank run and of a
    one-process run."""
    port = str(cs.free_port())
    procs = []
    for r in range(2):
        # each rank's temporary folder under the test's own
        os.makedirs(root / f"tmp{r}")
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="1", TMPDIR=str(root / f"tmp{r}"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "multi_modal_image_fusion_tpu_torch.cli."
             "train", *_train_args(root, "ckpt_dist", "--multihost")],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [o[-3000:] for o in outs]
    one = train_cli.main(_train_args(root, "ckpt_one"))
    dist_runs = sorted(os.listdir(root / "ckpt_dist"))
    return [str(root / "ckpt_dist" / d) for d in dist_runs], one


def test_only_rank0_writes_and_matches_one_process(root, runs):
    dist_runs, one = runs
    assert len(dist_runs) == 1, dist_runs
    # rank 1 wrote into a scratch folder of its own and removed it
    assert not os.listdir(root / "tmp1")
    log = open(os.path.join(dist_runs[0], "train.log")).read()
    assert "data parallel: rank 0 of 2 (gloo), global batch 4" in log
    assert "train iters/epoch: 2, valid iters/epoch: 1" in log
    got, want = (torch.load(os.path.join(d, "epoch_last.pth"),
                            weights_only=True) for d in (dist_runs[0], one))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    # the step moved the weights: the comparison is not of two inits
    init = create_model("deepfuse",
                        generator=torch.Generator().manual_seed(0))
    assert any(not torch.equal(v, want[k])
               for k, v in init.state_dict().items())


def test_global_batch_must_divide(root, monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--bs 3 .* world size 2"):
        train_cli.main(_train_args(root, "ckpt_bad", "--multihost") +
                       ["--bs", "3"])
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(root / "ckpt_bad")


def _test_args(root, *extra):
    return ["--data", "tiny", "--data_root", str(root / "data"),
            "--ckpt_root", str(root / "ckpt_test"), "--ckpt", "run",
            "--device", "cpu", *extra]


def test_test_cli_tiles_equal_untiled(root, capsys):
    ssim_tiled, _ = test_cli.main(_test_args(root, "--tiles", "2"))
    out = capsys.readouterr().out
    assert out.count("note: H=40 not divisible by the --tiles slab grid "
                     "multiple 16; reflect-padding to 48") == 1
    ssim_whole, _ = test_cli.main(_test_args(root, "--pad_bucket", "16"))
    assert "note:" not in capsys.readouterr().out
    assert np.isfinite(ssim_tiled)
    assert abs(ssim_tiled - ssim_whole) <= 1e-6


def test_test_cli_spatial(root):
    with pytest.raises(NotImplementedError, match="queue 1 item 7b"):
        test_cli.main(_test_args(root, "--spatial", "2"))
    ssim, _ = test_cli.main(_test_args(root, "--spatial", "1"))
    assert np.isfinite(ssim)
