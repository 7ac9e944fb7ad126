"""Two-phase height tiling of the port's multi-scale and global-fusion
models (parallel/tiling.py: tiled encode, fusion on the whole pyramids,
tiled decode) on the CPU, at the JAX package's tests/test_tiling.py shapes
and tolerances:

- NestFuse, RFNNest, MAFusion, UNFusion and Res2Fusion in 4 tiles at
  128x80 (UNFusion 192x80: its 48-row halo) equal to their whole forward
  within rtol 1e-5, atol 1e-6 (weights of a seeded init whose fused image
  is live);
- a bilinear align_corners upsample of a slab under
  ops/layers.tile_rows_ctx equal to the slab's rows of the whole-image
  one (F.interpolate) within f32 rounding, and to the JAX package's
  `interpolate` under its own tile_rows_ctx;
- a control that must miss: MAFusion's slabs with the tile context off.
"""

import contextlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.ops import layers as jlayers
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops.layers import (interpolate,
                                                           tile_rows_ctx)
from multi_modal_image_fusion_tpu_torch.parallel import tiling

# (name, weight seed with a live fused image, height)
MODELS = [("nestfuse", 9, 128), ("rfnnest", 2, 128), ("mafusion", 0, 128),
          ("unfusion", 2, 192), ("res2fusion", 0, 128)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(h, w, seed=0):
    r = np.random.RandomState(seed)
    return tuple(torch.from_numpy(r.rand(1, h, w, 1).astype(np.float32))
                 for _ in range(2))


def _whole_and_model(name, seed, h):
    model = create_model(name, generator=torch.Generator().manual_seed(seed))
    a, b = _pair(h, 80)
    with torch.no_grad():
        want = model(a, b)
    assert float((want > want.min()).float().mean()) > 0.99
    return model, a, b, want


@pytest.mark.parametrize("name,seed,h", MODELS)
def test_multiscale_4_tiles(name, seed, h):
    model, a, b, want = _whole_and_model(name, seed, h)
    with torch.no_grad():
        got = tiling.tiled_forward(model, a, b, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("scale,s_in,lo", [(2, 2, 16), (2, 8, 24),
                                           (4, 4, 0), (8, 8, 40)])
def test_tiled_bilinear_rows(scale, s_in, lo):
    """A feature at scale s_in of a 64-row image; the slab of full-res rows
    [lo, lo + 24) with one feature row of context on each inner side
    upsampled x`scale`: its rows but the context's are the whole upsample's
    (the context rows' sources lie outside the slab; the tiling discards
    them)."""
    full_h, core, c = 64, 24, 5
    r = np.random.RandomState(scale + s_in)
    x = r.randn(2, full_h // s_in, 7, c).astype(np.float32)
    s_out = s_in // scale
    top, bot = max(lo - s_in, 0), min(lo + core + s_in, full_h)
    slab = x[:, top // s_in:bot // s_in]
    keep = slice((lo - top) // s_out, (lo - top + core) // s_out)
    whole = interpolate(torch.from_numpy(x), scale, "bilinear")
    want = whole[:, lo // s_out:(lo + core) // s_out].numpy()
    with tile_rows_ctx(top, bot - top, full_h):
        got = interpolate(torch.from_numpy(slab), scale, "bilinear").numpy()
    np.testing.assert_allclose(got[:, keep], want, rtol=1e-6, atol=1e-6)
    with jlayers.tile_rows_ctx(top, bot - top, full_h):
        jax_got = jlayers.interpolate(jnp.asarray(slab), scale, "bilinear")
    np.testing.assert_allclose(got[:, keep], np.asarray(jax_got)[:, keep],
                               rtol=1e-6, atol=1e-6)
    # outside the context the slab is upsampled on its own geometry
    plain = interpolate(torch.from_numpy(slab), scale, "bilinear").numpy()
    assert float(np.abs(plain[:, keep] - want).max()) > 1e-3


def test_slabs_contiguous_batch_2():
    """At batch 2 a slab of rows is a strided view; the kernels on the card
    take contiguous NHWC tensors only, so every slab the model's parts
    receive is contiguous (the CPU's plain versions would not notice)."""
    model = create_model("mafusion", generator=torch.Generator().manual_seed(0))
    seen = []
    for part in ("encoder", "decode_feats"):
        fn = getattr(model, part)

        def spy(x, *rest, fn=fn):
            seen.extend(t.is_contiguous() for t in
                        (x if isinstance(x, (list, tuple)) else [x]))
            return fn(x, *rest)
        setattr(model, part, spy)
    r = np.random.RandomState(1)
    a, b = (torch.from_numpy(r.rand(2, 64, 24, 1).astype(np.float32))
            for _ in range(2))
    with torch.no_grad():
        tiling.tiled_forward(model, a, b, 2)
    assert len(seen) == 2 * (1 + 4) and all(seen)


def test_control_mafusion_without_tile_context_misses():
    model, a, b, want = _whole_and_model("mafusion", 0, 128)
    with torch.no_grad(), mock.patch.object(
            tiling, "tile_rows_ctx", lambda *_: contextlib.nullcontext()):
        got = tiling.tiled_forward(model, a, b, 4)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err > 1e-3, err
