"""Single-card height tiling of the port, whole-model slabs
(parallel/tiling.py), on the CPU, at the JAX package's tests/test_tiling.py
shapes and tolerances:

- the 8 eligible models at 96x81 in 4 tiles equal to their whole forward
  within 1e-6 (weights of a seeded init whose fused image is live);
  DeepFuse at 2 tiles, batch 2, 128x64; DIFNet at 6 tiles, 144x48;
- one tile is the forward itself; the JAX geometry rejections (DeepFuse
  at 5 and 48 tiles, SEDRFuse, NestFuse's two-phase slabs at 120 rows);
- the port's `receptive_halo` equal to JAX's for the 8 eligible models;
- DeepFuse tiled against the JAX whole-image forward with the weights
  carried, within 1e-4;
- DeepFuse under int8 (one calibration) tiled equal to whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_step_common as sc
from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.parallel.spatial import \
    receptive_halo as jax_halo
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops.quant import (calibrate,
                                                          quantized_inference)
from multi_modal_image_fusion_tpu_torch.parallel.spatial import \
    receptive_halo
from multi_modal_image_fusion_tpu_torch.parallel.tiling import tiled_forward

ELIGIBLE = ("deepfuse", "densefuse", "vifnet", "pfnetv1", "pfnetv2",
            "ifcnn", "difnet", "pmgi")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(h, w, seed=0, batch=1):
    r = np.random.RandomState(seed)
    return tuple(torch.from_numpy(r.rand(batch, h, w, 1).astype(np.float32))
                 for _ in range(2))


def _model(name, seed=0):
    return create_model(name, generator=torch.Generator().manual_seed(seed))


def _check(model, a, b, n):
    with torch.no_grad():
        want = model(a, b)
        got = tiled_forward(model, a, b, n)
    # a live fused image: a constant one would hold vacuously
    assert float((want > want.min()).float().mean()) > 0.99
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ELIGIBLE)
def test_eligible_models_4_tiles(name):
    _check(_model(name), *_pair(96, 81), 4)


def test_two_tiles_batch():
    """n=2 (no interior slab), batch 2: each slab handed to the model is a
    contiguous copy (the card's kernels take no strided view)."""
    model = _model("deepfuse")
    forward = model.forward

    def spy(a, b):
        assert a.is_contiguous() and b.is_contiguous()
        return forward(a, b)
    _check(model, *_pair(128, 64, batch=2), 2)
    model.forward = spy
    with torch.no_grad():
        tiled_forward(model, *_pair(128, 64, batch=2), 2)


def test_many_tiles():
    _check(_model("difnet"), *_pair(144, 48), 6)


def test_single_tile_passthrough():
    model = _model("deepfuse")
    a, b = _pair(32, 32)
    with torch.no_grad():
        assert torch.equal(tiled_forward(model, a, b, 1), model(a, b))


def test_rejections():
    a, b = _pair(96, 32)
    model = _model("deepfuse")
    with pytest.raises(ValueError, match="not divisible"):
        tiled_forward(model, a, b, 5)
    with pytest.raises(ValueError, match="receptive halo"):
        tiled_forward(model, a, b, 48)
    a, b = _pair(64, 32)
    with pytest.raises(ValueError, match="height-shard"):
        tiled_forward(_model("sedrfuse"), a, b, 2)
    a, b = _pair(120, 48)     # slabs of 30 rows
    with pytest.raises(ValueError, match="multiples of 8"):
        tiled_forward(_model("nestfuse"), a, b, 4)


@pytest.mark.parametrize("name", ELIGIBLE)
def test_receptive_halo_equals_jax(name):
    assert receptive_halo(_model(name)) == jax_halo(sc.variables(name))


def test_deepfuse_tiled_vs_jax_whole():
    v = sc.variables("deepfuse")
    a, b = _pair(96, 40, seed=5)
    with jax.default_matmul_precision("float32"):
        want = jcreate("deepfuse").apply(v, jnp.asarray(a.numpy()),
                                         jnp.asarray(b.numpy()), train=False)
    model = sc.port_model("deepfuse", {}, v).eval()
    with torch.no_grad():
        got = tiled_forward(model, a, b, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_deepfuse_int8_tiled_equals_whole():
    model = _model("deepfuse")
    a, b = _pair(96, 40, seed=2)
    amax = calibrate(model, [(a, b)])
    with torch.no_grad(), quantized_inference(amax):
        want = model(a, b)
        got = tiled_forward(model, a, b, 4)
    with torch.no_grad():
        assert not torch.equal(want, model(a, b))     # the int8 route ran
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
