"""The port's RFNNest (plain path, CPU) against the JAX package
(harness: tests/test_torch_nest_common.py):

- JAX `model.apply` (fusion by the four RFNs) and autoencoder mode at 32x32
  and 45x61, and one RFN block against the JAX block's eager route;
- the JAX H-major multi-leg route (`_hiw_forward` with `_hiw_fuse`: each
  RFN's res and fuse1 as legs of conv_hiw_chain_multi, res over the two
  halves of one batch) in the Pallas interpreter at narrowed widths;
- the reference PyTorch goldens, the parameter count and state-dict
  shapes, the weight carry round trip;
- the serving routes at the published widths, counted on the CPU as the
  card's launches: NestFuse's, and 2 conv_multi and 4 conv_chain an RFN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_nest_common as common
from multi_modal_image_fusion_tpu.ops.blocks import RFN as JRFN
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops.blocks import RFN

NAME = "rfnnest"
LAUNCHES = {"conv_gray_enter": 1, "conv_chain": 28, "conv_wide": 7,
            "conv_multi": 9, "conv_gray_exit": 1}
NESTFUSE_AE = {"conv_gray_enter": 1, "conv_chain": 12, "conv_wide": 7,
               "conv_multi": 1, "conv_gray_exit": 1}


@pytest.mark.parametrize("hw", common.HWS)
@pytest.mark.parametrize("ae", [False, True], ids=["rfn", "ae"])
def test_vs_jax_apply(ae, hw):
    common.check_vs_apply(NAME, hw, ae)


def test_rfn_block_vs_jax():
    """RFN(c)(f, n) on the 2n-image batch f against the JAX block's eager
    route on its halves (the concat built), weights carried by name."""
    c, n = 24, 2
    r = np.random.RandomState(3)
    f = r.rand(2 * n, 13, 17, c).astype(np.float32)
    jm = JRFN(c)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(f[:n]),
                jnp.asarray(f[n:]))
    params = jax.tree.map(np.array, v["params"])
    block = RFN(c)
    names = {"res": "res", "conv1": "conv1", "conv2": "conv2",
             "fuse1": "layers.0", "fuse2": "layers.1", "fuse3": "layers.2"}
    sd = {}
    for jname, pname in names.items():
        leaf = params[jname]
        sd[f"{pname}.layers.0.weight"] = torch.from_numpy(
            np.ascontiguousarray(leaf["kernel"].transpose(3, 2, 0, 1)))
        sd[f"{pname}.layers.0.bias"] = torch.from_numpy(
            0.1 * (r.rand(c).astype(np.float32) - 0.5))
        leaf["bias"] = sd[f"{pname}.layers.0.bias"].numpy()
    block.load_state_dict(sd)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(f[:n]),
                                   jnp.asarray(f[n:])))
    with torch.no_grad():
        got = block(torch.from_numpy(f), n).numpy()
    assert got.shape == (n, 13, 17, c)
    np.testing.assert_allclose(got, want, atol=common.ATOL)


def test_vs_jax_hiw_route(monkeypatch):
    common.check_fast_route(NAME, monkeypatch)


def test_vs_reference_goldens(golden):
    common.check_goldens(NAME, golden(f"model_fwd_{NAME}"))


def test_param_count_and_names():
    common.check_counts(NAME, "RFNNest")


def test_weight_carry_round_trip():
    common.check_round_trip(NAME, common.variables(NAME))


@pytest.mark.parametrize("where", ["top", "block", "conv"])
def test_weight_carry_rejects_leftovers(where):
    common.check_rejects_leftovers(NAME, common.variables(NAME), where)


def test_serving_routes(monkeypatch):
    model = create_model(NAME).eval()
    x1, x2 = torch.rand(1, 16, 24, 1), torch.rand(1, 16, 24, 1)
    assert common.kernel_calls(monkeypatch, model, x1, x2) == LAUNCHES
    assert common.kernel_calls(monkeypatch, model, x1) == NESTFUSE_AE
