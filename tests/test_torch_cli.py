"""The port's test CLI (`--device cpu`) against the JAX test CLI, on one set
of weights saved both as a JAX msgpack checkpoint and as the port's .pth:
mean SSIM within 1e-4, NN.bmp dumps within 1 LSB (f32 on both sides;
the dumps round the same fused values to uint8), train.log appended with
fps; the partial-checkpoint message; no silent CPU fallback; and default
roots inside the checkout."""

import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.cli import test as jax_test_cli
from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.train.checkpoint import save_checkpoint
from multi_modal_image_fusion_tpu_torch.cli import common as cli_common
from multi_modal_image_fusion_tpu_torch.cli import test as test_cli
from multi_modal_image_fusion_tpu_torch.data.io import imread_gray, imwrite
from multi_modal_image_fusion_tpu_torch.train.checkpoint import \
    save_state_dict
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    data = root / "datasets" / "tinyset"
    rng = np.random.RandomState(0)
    for mod in ("vis", "ir"):
        os.makedirs(data / "test" / mod)
    for i, (h, w) in enumerate([(40, 56), (33, 47)]):
        base = (rng.rand(h, w) * 255).astype(np.uint8)
        noise = (rng.rand(h, w) * 60).astype(np.uint8)
        imwrite(str(data / "test" / "vis" / f"{i + 1}.png"), base)
        imwrite(str(data / "test" / "ir" / f"{i + 1}.png"),
                255 - base // 2 + noise // 3)

    model = jcreate("deepfuse")
    x = jnp.zeros((1, 32, 32, 1), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x, x, train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    r = np.random.RandomState(1)
    for leaf in params.values():
        leaf["bias"] = (0.1 * (r.rand(*leaf["bias"].shape) - 0.5)).astype(
            np.float32)
    meta = {"model": "deepfuse"}
    save_checkpoint(str(root / "jax" / "run" / "epoch_best.ckpt"),
                    {"params": params}, meta=meta)
    sd = jax_to_state_dict({"params": params}, "deepfuse")
    save_state_dict(str(root / "port" / "run" / "epoch_best.pth"), sd,
                    meta=meta)
    for side in ("jax", "port"):
        (root / side / "run" / "train.log").write_text("epoch 1")
    # a stage-1 style checkpoint without the decoder
    save_state_dict(str(root / "part" / "run" / "epoch_last.pth"),
                    {k: v for k, v in sd.items() if k.startswith("encode")})
    return root


def _args(root, side, *extra):
    return ["--data", "tinyset", "--data_root", str(root / "datasets"),
            "--ckpt_root", str(root / side), "--ckpt", "run", *extra]


@pytest.mark.parametrize("pad_bucket", ["0", "32"])
def test_cli_matches_jax_cli(setup, pad_bucket):
    root = setup
    ssim_j, _ = jax_test_cli.main(_args(root, "jax", "--pad_bucket",
                                        pad_bucket))
    ssim_p, t_p = test_cli.main(_args(root, "port", "--device", "cpu",
                                      "--pad_bucket", pad_bucket))
    assert np.isfinite(ssim_p) and t_p > 0
    assert abs(ssim_p - ssim_j) <= 1e-4, (ssim_p, ssim_j)
    for i in (1, 2):
        name = f"{i:0>2}.bmp"
        a = imread_gray(str(root / "jax" / "run" / "tinyset" / name))
        b = imread_gray(str(root / "port" / "run" / "tinyset" / name))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1.0
    log = (root / "port" / "run" / "train.log").read_text()
    assert log.startswith("epoch 1") and "fps" in log


def test_cli_partial_checkpoint(setup, capsys):
    ssim, _ = test_cli.main(_args(setup, "part", "--device", "cpu"))
    assert np.isfinite(ssim)
    out = capsys.readouterr().out
    assert "partial checkpoint: 6 leaves kept at init" in out
    assert "0 checkpoint-only leaves dropped" in out


def test_cli_without_card_raises(setup, monkeypatch):
    """No --device cpu and no CUDA: the CLI raises instead of falling back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_cli.main(_args(setup, "port"))


def test_cli_missing_checkpoint_raises(setup, tmp_path):
    with pytest.raises(FileNotFoundError):
        test_cli.main(["--data", "tinyset", "--data_root",
                       str(setup / "datasets"), "--ckpt_root",
                       str(tmp_path), "--ckpt", "none", "--device", "cpu"])


def test_cli_default_roots_stay_in_checkout(setup, tmp_path, monkeypatch):
    """Without --data_root and --ckpt_root the CLI reads <repo>/datasets and
    writes <repo>/checkpoints of the checkout holding the package, never a
    folder beside the checkout."""
    monkeypatch.delenv("MMIF_SAMPLES_DIR", raising=False)
    repo = Path(test_cli.__file__).resolve().parents[2]
    assert cli_common.REPO_ROOT == repo
    args = cli_common.get_test_parser().parse_args(["--ckpt", "run"])
    for path in (cli_common.ckpt_root(args),
                 cli_common.resolve_data_dir(args)[0]):
        assert Path(path).resolve().is_relative_to(repo), path
    # main() with the defaults, against a stand-in checkout
    shutil.copytree(setup / "datasets", tmp_path / "datasets")
    shutil.copytree(setup / "port", tmp_path / "checkpoints")
    monkeypatch.setattr(cli_common, "REPO_ROOT", tmp_path)
    ssim, _ = test_cli.main(["--data", "tinyset", "--ckpt", "run",
                             "--device", "cpu"])
    assert np.isfinite(ssim)
    for i in (1, 2):
        assert (tmp_path / "checkpoints" / "run" / "tinyset"
                / f"{i:0>2}.bmp").is_file()
    assert "fps" in (tmp_path / "checkpoints" / "run" / "train.log").read_text()
