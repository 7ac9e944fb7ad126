"""The port's int8 inference of PFNetv1 and PFNetv2 (its fuse net the
channels-into-batch fold, on conv_int8 as in the JAX package), and their
calibration, against the JAX package's int8 route on the CPU (harness and
tolerances: tests/test_torch_int8_common.py)."""

import pytest

import test_torch_int8_common as common

from multi_modal_image_fusion_tpu_torch.ops import layers

KEYS = ["pfnetv1", "pfnetv2"]


@pytest.mark.parametrize("key", KEYS)
def test_calibrate_matches_jax(key):
    common.check_calibrate(key)


@pytest.mark.parametrize("key", KEYS)
def test_models_int8_vs_jax(key):
    common.check_int8(key)


def test_pfnetv2_fuse_net_runs_int8(monkeypatch):
    """Every int8-eligible layer of PFNetv2, the fuse net's three included,
    runs conv_int8 once a forward."""
    model = common.port_model("pfnetv2")
    calls = []
    real = layers.conv_int8

    def spy(x, qw, *a, **kw):
        calls.append(tuple(qw.shape))
        return real(x, qw, *a, **kw)
    monkeypatch.setattr(layers, "conv_int8", spy)
    common.port_int8("pfnetv2", model)
    assert len(calls) == len(common.int8_layers(model)) == 11
    assert calls.count((2, 2, 3, 3)) == 2 and (1, 2, 3, 3) in calls
