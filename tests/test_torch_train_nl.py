"""Res2Fusion's train step through the 'nl' attention's autograd Function
(ops/cuda/nl_attention.NLSpatialFlash, the counterpart of the JAX
package's custom VJP `_nl_spatial_flash_diff`) on CPU tensors, against
the JAX step (harness: tests/test_torch_step_common.py, the JAX side in
float64: its f32 gradients lie up to 6.9e-4 of the largest from float64
at this step, the port's 6.4e-7): loss parts within 2e-5, gradients within 1e-4
of the largest, plain and with `fast=True`. Every 'nl' spatial pooling of
the step goes through the Function (two: one a modality). The control
zeroes q's gradient in the Function's backward: the step's gradients must
then miss the JAX step's."""

import pytest
import torch

import test_torch_step_common as sc
from multi_modal_image_fusion_tpu_torch.ops import fusion
from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import \
    NLSpatialFlash

NAME = "res2fusion"


def _count(monkeypatch):
    calls = []
    real = fusion.nl_spatial_diff

    def spy(q, k):
        calls.append(q.shape)
        return real(q, k)
    monkeypatch.setattr(fusion, "nl_spatial_diff", spy)
    return calls


@pytest.mark.parametrize("fast", [False, True])
def test_nl_step_matches_jax(fast, monkeypatch):
    calls = _count(monkeypatch)
    sc.check_step(NAME, fast, x64=True)
    assert calls == [(2, 32 * 32, 112)] * 2


def test_nl_backward_without_dq_misses(monkeypatch):
    js = sc.jax_step(NAME, x64=True)
    backward = NLSpatialFlash.backward

    def no_dq(ctx, g):
        dq, dk = backward(ctx, g)
        return torch.zeros_like(dq), dk
    monkeypatch.setattr(NLSpatialFlash, "backward", staticmethod(no_dq))
    _, grads, _ = sc.port_step(sc.port_model(NAME, {}, js["variables"]),
                               False)
    jg = sc.to_port(NAME, {}, js["grads"], {})
    scale = max(float(g.abs().max()) for g in jg.values())
    worst = max(float((g - jg[k]).abs().max()) for k, g in grads.items())
    assert worst > sc.GRAD_TOL * scale
