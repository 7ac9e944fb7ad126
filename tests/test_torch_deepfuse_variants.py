"""The port's DeepFuse opt-in chain routes (MMIF_CHAIN_PAIR, MMIF_S2D,
MMIF_S2D_IO; models/zoo.py) against the JAX package's, on the CPU.

The JAX side runs its serving chain as its own model tests do: under
`fast_inference` with MMIF_CHAIN_INTERPRET=1, so conv_tlane_chain_pair,
conv_tlane_chain (with s2d_f=2 on the packed route) and the H-major chain
run in the Pallas interpreter. The port runs its plain versions (CPU
tensors). Weights are the JAX model's init with seeded biases, carried by
jax_to_state_dict; images come from a numpy seed. Tolerance 1e-4, the
docs/PARITY.md model-forward budget (f32 on both sides).

Which route ran is asserted on both sides: a spy counts the JAX package's
conv_tlane_chain_pair and s2d_pack calls, and the port's `route()` and a
spy on its kernel wrappers say the same of the port. MMIF_S2D=1 alone
reaches no packed chain in the JAX package (its H-major route, on by
default, is taken first), so the packed cases also set MMIF_CHAIN_HIW=0.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_image_fusion_tpu.models import create_model as jcreate
from multi_modal_image_fusion_tpu.ops import quant as jquant
from multi_modal_image_fusion_tpu.ops import s2d as js2d
from multi_modal_image_fusion_tpu.ops.layers import fast_inference
from multi_modal_image_fusion_tpu.ops.pallas import conv_kernel as jck
from multi_modal_image_fusion_tpu_torch.models import create_model
from multi_modal_image_fusion_tpu_torch.models import zoo
from multi_modal_image_fusion_tpu_torch.ops import layers, quant
from multi_modal_image_fusion_tpu_torch.utils.jax_convert import \
    jax_to_state_dict

ATOL = 1e-4
SWITCHES = ("MMIF_CHAIN_PAIR", "MMIF_S2D", "MMIF_S2D_IO", "MMIF_CHAIN_HIW",
            "MMIF_HIW_INT8")


def _pair(seed, b, h, w):
    r = np.random.RandomState(seed)
    return (r.rand(b, h, w, 1).astype(np.float32),
            r.rand(b, h, w, 1).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _variables(mode):
    x = jnp.zeros((1, 16, 16, 1), jnp.float32)
    v = jcreate("deepfuse", fusion_mode=mode).init(jax.random.PRNGKey(0), x,
                                                   x, train=False)
    r = np.random.RandomState(100)
    params = jax.tree.map(np.array, v["params"])
    for leaf in params.values():
        leaf["bias"] = (0.1 * (r.rand(*leaf["bias"].shape) - 0.5)).astype(
            np.float32)
    return {"params": params}


def _port(mode):
    model = create_model("deepfuse", fusion_mode=mode)
    model.load_state_dict(jax_to_state_dict(_variables(mode), "deepfuse"))
    return model.eval()


class _Spy:
    """Counts calls of module attributes while keeping their behaviour."""

    def __init__(self, monkeypatch):
        self.mp, self.calls = monkeypatch, {}

    def watch(self, module, name):
        fn = getattr(module, name)
        self.calls.setdefault(name, 0)

        def wrapped(*a, **k):
            self.calls[name] += 1
            return fn(*a, **k)
        self.mp.setattr(module, name, wrapped)


@pytest.fixture
def env(monkeypatch):
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("MMIF_CHAIN_INTERPRET", "1")

    def set_(**kv):
        for k, v in kv.items():
            monkeypatch.setenv(k, v)
    return set_


@pytest.fixture
def spy(monkeypatch):
    s = _Spy(monkeypatch)
    s.watch(jck, "conv_tlane_chain_pair")
    s.watch(js2d, "s2d_pack")
    for name in ("conv_pair_enter", "conv_pair_exit", "s2d_enter",
                 "s2d_exit", "s2d_pack"):
        s.watch(zoo, name)
    s.watch(layers, "conv_wide")
    return s.calls


def _run_both(mode, x1, x2, amax=None):
    """(JAX output, port output, the port's route)."""
    jm = jcreate("deepfuse", fusion_mode=mode)
    port = _port(mode)
    q_j = (jquant.quantized_inference(amax) if amax is not None
           else contextlib.nullcontext())
    q_p = (quant.quantized_inference(amax) if amax is not None
           else contextlib.nullcontext())
    with fast_inference(), q_j:
        want = np.asarray(jm.apply(_variables(mode), jnp.asarray(x1),
                                   jnp.asarray(x2), train=False))
    with torch.no_grad(), q_p:
        a, b = torch.from_numpy(x1), torch.from_numpy(x2)
        route = port.route(a, b)
        got = port(a, b).numpy()
    assert got.shape == want.shape
    return want, got, route


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("value", ["1", "0"])
def test_pair_route_vs_jax(env, spy, mode, value):
    """MMIF_CHAIN_PAIR (any non-empty value, "0" too): the JAX pair route
    (two conv_tlane_chain_pair calls) against the port's (conv_pair_enter,
    dec0 on conv_chain, conv_pair_exit)."""
    env(MMIF_CHAIN_PAIR=value)
    x1, x2 = _pair(1, 2, 24, 40)
    want, got, route = _run_both(mode, x1, x2)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert route == "pair"
    assert spy["conv_tlane_chain_pair"] == 2
    assert spy["conv_pair_enter"] == spy["conv_pair_exit"] == 1


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_packed_route_vs_jax(env, spy, mode):
    """MMIF_S2D=1 MMIF_CHAIN_HIW=0 at 30x44: packed height 15 reaches the
    bottom mirror; 'sum' is dec0's fuse_n on packed legs, 'mean' fuses the
    packed halves."""
    env(MMIF_S2D="1", MMIF_CHAIN_HIW="0")
    x1, x2 = _pair(2, 2, 30, 44)
    want, got, route = _run_both(mode, x1, x2)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert route == "s2d"
    assert spy["s2d_pack"] == 2          # one on each side
    assert spy["conv_wide"] == 5 and spy["s2d_enter"] == 0


def test_packed_route_with_io_switch_on_f32(env, spy):
    """MMIF_S2D_IO=1 on an f32 chain: s2d_io_ok refuses f32 in both
    packages, so the torch pack is the glue (the JAX package's XLA
    s2d_pack)."""
    env(MMIF_S2D="1", MMIF_CHAIN_HIW="0", MMIF_S2D_IO="1")
    x1, x2 = _pair(3, 1, 32, 256)
    want, got, route = _run_both("sum", x1, x2)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert route == "s2d" and spy["s2d_enter"] == 0
    assert spy["s2d_pack"] == 2


@pytest.mark.parametrize("case", ["s2d_alone", "odd"])
def test_no_packed_route(env, spy, case):
    """MMIF_S2D=1 alone (the JAX package takes its H-major route first),
    and an odd size with MMIF_CHAIN_HIW=0 (no packed chain): no pack on
    either side, the default route."""
    if case == "odd":
        env(MMIF_S2D="1", MMIF_CHAIN_HIW="0")
        x1, x2 = _pair(4, 1, 29, 43)
    else:
        env(MMIF_S2D="1")
        x1, x2 = _pair(4, 1, 24, 32)
    want, got, route = _run_both("sum", x1, x2)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert route == "default"
    assert spy["s2d_pack"] == 0 and spy["conv_tlane_chain_pair"] == 0


def _amax(mode, x1, x2):
    return quant.calibrate(_port(mode), [(torch.from_numpy(x1),
                                          torch.from_numpy(x2))])


def test_int8_with_pair_switch_is_the_float_pair_route(env, spy):
    """Under int8 with MMIF_CHAIN_PAIR set the JAX forward skips its int8
    chain for the float pair route; so does the port's."""
    x1, x2 = _pair(5, 1, 32, 128)
    amax = _amax("sum", x1, x2)
    env(MMIF_CHAIN_PAIR="1")
    want, got, route = _run_both("sum", x1, x2, amax)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert route == "pair" and spy["conv_tlane_chain_pair"] == 2
    _, float_out, _ = _run_both("sum", x1, x2)
    np.testing.assert_allclose(got, float_out, atol=ATOL)


def test_int8_without_pair_switch_runs_the_int8_chain(env, spy, monkeypatch):
    x1, x2 = _pair(5, 1, 32, 128)
    amax = _amax("sum", x1, x2)
    s = _Spy(monkeypatch)
    s.watch(layers, "conv_int8_chain")
    port = _port("sum")
    a, b = torch.from_numpy(x1), torch.from_numpy(x2)
    with torch.no_grad():
        float_out = port(a, b)
        with quant.quantized_inference(amax):
            assert port.route(a, b) == "int8_chain"
            got = port(a, b)
    assert s.calls["conv_int8_chain"] == 3
    assert spy["conv_pair_enter"] == 0
    assert float((got - float_out).abs().max()) > 1e-3


@pytest.mark.parametrize("switches", [{"MMIF_CHAIN_PAIR": "1"},
                                      {"MMIF_S2D": "1",
                                       "MMIF_CHAIN_HIW": "0"}])
def test_calibration_records_every_layer(env, spy, switches):
    """calibrate takes the default route with a switch set: the same amax
    keys and values as without."""
    x1, x2 = _pair(6, 1, 24, 32)
    want = _amax("sum", x1, x2)
    env(**switches)
    got = _amax("sum", x1, x2)
    assert sorted(got) == sorted(want) and len(got) == 5
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert spy["conv_pair_enter"] == 0 and spy["conv_wide"] == 0


def test_routes_step_aside_for_training_and_gradients(env):
    """A gradient (the parameters' outside no_grad, or an input's), a
    trainer scope and autoencoder mode take the default route (the JAX
    package's `not train`)."""
    env(MMIF_CHAIN_PAIR="1")
    port = _port("sum")
    a, b = (torch.from_numpy(x) for x in _pair(7, 1, 16, 16))
    assert port.route(a, b) == "default"
    with torch.no_grad():
        assert port.route(a, b) == "pair"
        assert port.route(a) == "default"
        with layers.fast_training(False):
            assert port.route(a, b) == "default"
    port.requires_grad_(False)
    assert port.route(a, b) == "pair"
    a.requires_grad_(True)
    assert port.route(a, b) == "default"
