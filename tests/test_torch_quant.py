"""The port's int8 quantizers and calibration (ops/quant.py) against the JAX
package's (ops/quant.py, ops/pallas/conv_int8.py, ops/pallas/hiw_int8.py),
on the CPU, with inputs made from a numpy seed:

- quantize_weights: the same integers and scales;
- choose_fold: within two ulps of JAX's f in every mode (XLA's f32 pow
  and the port's f64 square root rounded once differ in the last bit now
  and then, and one product can double that); given JAX's f, the input
  quantizers (the division and the reciprocal multiply) give the same
  integers;
- quant_skipped: suffix and exact-path entries, the context's set and
  MMIF_INT8_SKIP;
- DeepFuse's int8 leg and hop rule against hiw_q_ok / hiw_q_res_ok at
  DeepFuse's widths;
- calibrate: the same keys as JAX `calibrate` for all 6 ported models at
  32x32 over two batches, each layer's values within 1e-5 of its largest
  (the float forwards that feed them agree to f32 rounding; the model
  tests hold them at 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.ops import quant as jquant
from multi_modal_image_fusion_tpu.ops.pallas import conv_int8 as jq
from multi_modal_image_fusion_tpu.ops.pallas.hiw_int8 import (hiw_q_ok,
                                                              hiw_q_res_ok)
from multi_modal_image_fusion_tpu.ops.pallas.hiw_kernel import hiw_pick_g
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.ops import quant
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import (
    flax_paths, jax_to_state_dict)

MODELS = ["deepfuse", "densefuse", "vifnet", "dbnet", "res2fusion",
          "unfusion"]


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w_hwio), (3, 2, 0, 1))))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_quantize_weights_equal():
    r = np.random.RandomState(0)
    for shape in [(7, 7, 16, 32), (3, 3, 1, 16), (1, 1, 64, 1)]:
        w = (r.rand(*shape) - 0.5).astype(np.float32)
        w[..., 0] = 0.0                           # a dead output channel
        qj, sj = jq.quantize_weights(jnp.asarray(w))
        qt, st = quant.quantize_weights(_oihw(w))
        np.testing.assert_array_equal(qt.numpy(), _oihw(qj).numpy())
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("mode", ["smooth", "channel", "tensor"])
@pytest.mark.parametrize("alpha,clip", [(None, None), (0.3, 0.9)])
def test_choose_fold_within_ulps(mode, alpha, clip):
    r = np.random.RandomState(1)
    worst = 0
    for _ in range(20):
        cin, cout, k = 48, 16, 3
        amax = (r.rand(cin) * (r.rand(cin) > 0.1)).astype(np.float32)
        w = (r.rand(k, k, cin, cout) - 0.5).astype(np.float32)
        w[:, :, 3] = 0.0                          # a dead input channel
        fj = jq.choose_fold(jnp.asarray(amax), jnp.asarray(w), mode, alpha,
                            clip)
        ft = quant.choose_fold(amax, _oihw(w), mode, alpha, clip)
        assert ft.dtype == torch.float32
        worst = max(worst, int(_ulps(fj, ft.numpy()).max()))
    assert worst <= 2, worst


def test_choose_fold_reads_env(monkeypatch):
    r = np.random.RandomState(2)
    amax = r.rand(16).astype(np.float32)
    w = (r.rand(3, 3, 16, 8) - 0.5).astype(np.float32)
    monkeypatch.setenv("MMIF_INT8_ALPHA", "0.25")
    monkeypatch.setenv("MMIF_INT8_CLIP", "0.5")
    fj = jq.choose_fold(jnp.asarray(amax), jnp.asarray(w))
    ft = quant.choose_fold(amax, _oihw(w))
    assert _ulps(fj, ft.numpy()).max() <= 2
    np.testing.assert_array_equal(
        ft.numpy(), quant.choose_fold(amax, _oihw(w), "smooth", 0.25,
                                      0.5).numpy())


def test_input_quantizers_equal_given_jax_fold():
    """Given JAX's f, the division (ConvLayer route) and the reciprocal
    multiply (chain) give JAX's integers, and they are different
    functions."""
    r = np.random.RandomState(3)
    x = ((r.rand(4, 33, 47, 32) - 0.3) * 3).astype(np.float32)
    w = (r.rand(7, 7, 32, 32) - 0.5).astype(np.float32)
    f = jq.choose_fold(jnp.max(jnp.abs(x), axis=(0, 1, 2)), jnp.asarray(w))
    ft = torch.from_numpy(np.asarray(f))
    q_div = quant.quantize_input_scaled(torch.from_numpy(x), ft)
    np.testing.assert_array_equal(
        q_div.numpy(), np.asarray(jq.quantize_input_scaled(jnp.asarray(x),
                                                           f)))
    q_mul = quant.quantize_input_recip(torch.from_numpy(x), 1.0 / ft)
    want = jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / f)), -127, 127)
    np.testing.assert_array_equal(q_mul.numpy(), np.asarray(want))
    assert q_div.dtype == q_mul.dtype == torch.int8


def test_quant_skipped_semantics(monkeypatch):
    monkeypatch.delenv("MMIF_INT8_SKIP", raising=False)
    assert not quant.quant_skipped("dec1")
    with quant.quantized_inference({}, skip=("dec1", "RB1/pwconv1")):
        assert quant.quant_skipped("dec1")
        assert quant.quant_skipped("decode/DB1_1/dec1")   # leaf suffix
        assert quant.quant_skipped("RB1/pwconv1")         # exact path
        assert not quant.quant_skipped("RB2/pwconv1")
        assert not quant.quant_skipped("dec10")
        assert not quant.quant_skipped(None)
        monkeypatch.setenv("MMIF_INT8_SKIP", "enc0,encode/EB2_1/conv1")
        assert quant.quant_skipped("enc0")                # env adds
        assert quant.quant_skipped("encode/EB2_1/conv1")
        assert not quant.quant_skipped("encode/EB3_1/conv1")
    assert quant.quant_skipped("enc0") and not quant.quant_skipped("dec1")
    assert quant.default_skip("DeepFuse") == ()


def test_deepfuse_leg_and_hop_rule_matches_jax_gates():
    """The port's rule picks, at DeepFuse's widths, the legs hiw_q_ok
    admits and the hops hiw_q_res_ok admits."""
    legs = [(1, 16, 5, "relu"), (16, 32, 7, "relu"), (32, 32, 7, "relu"),
            (32, 16, 5, "relu"), (16, 1, 5, None)]
    want = [c_out > 1 and hiw_q_ok(c_in, c_out, k) for c_in, c_out, k, _
            in legs]
    got = [quant.chain_leg_ok(c_in, c_out) for c_in, c_out, _, _ in legs]
    assert got == want == [False, True, True, True, False]
    # the hops the JAX chain takes: enc1 -> dec0 and dec0 -> dec1
    for p, c in [(1, 2), (2, 3)]:
        (pc_in, pc_out, pk, pact), (cc_in, cc_out, ck, _) = legs[p], legs[c]
        jax_hop = hiw_q_res_ok(pc_out, ck, hiw_pick_g(pc_in, pc_out, pk),
                               hiw_pick_g(cc_in, cc_out, ck))
        assert quant.chain_hop_ok(pact) == jax_hop is True
    assert not quant.chain_hop_ok("relu6") and quant.chain_hop_ok(None)


def _with_bias(tree, r):
    for leaf in tree.values():
        if "bias" in leaf:
            leaf["bias"] = (0.1 * (r.rand(*leaf["bias"].shape)
                                   - 0.5)).astype(np.float32)
        elif "kernel" not in leaf:
            _with_bias(leaf, r)


@functools.lru_cache(maxsize=None)
def _variables(name):
    x = jnp.zeros((1, 32, 32, 1), jnp.float32)
    v = jax.jit(functools.partial(jcreate(name).init, train=False))(
        jax.random.PRNGKey(0), x, x)
    params = jax.tree.map(np.array, v["params"])
    _with_bias(params, np.random.RandomState(1))
    return {"params": params}


@pytest.mark.parametrize("name", MODELS)
def test_calibrate_matches_jax(name):
    variables = _variables(name)
    model = create_model(name)
    model.load_state_dict(jax_to_state_dict(variables, name))
    model.eval()
    r = np.random.RandomState(4)
    batches = [tuple(r.rand(1, 32, 32, 1).astype(np.float32)
                     for _ in range(2)) for _ in range(2)]
    with jax.default_matmul_precision("float32"):
        want = jquant.calibrate(jcreate(name), variables,
                                [tuple(jnp.asarray(b) for b in bt)
                                 for bt in batches])
    got = quant.calibrate(model, [tuple(torch.from_numpy(b) for b in bt)
                                  for bt in batches])
    assert set(got) == set(want)
    # every conv layer of the model has its key (Res2Fusion's dead dwconv
    # included, as the JAX eager route calls it)
    assert set(got) == set(flax_paths(name).values())
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].dtype == np.float32 and got[key].shape == w.shape
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=1e-5 * max(float(w.max()), 1e-30),
                                   err_msg=key)
    # the first layer sees the images: exact, and max-reduced over batches
    first = {"deepfuse": "enc0", "dbnet": "conv_in",
             "unfusion": "CB1_0"}.get(name, "conv_in")
    top = max(float(np.max(b)) for bt in batches for b in bt)
    assert got[first].tolist() == [top]
