"""Post-training int8 inference of the port (counterpart of
multi_modal_image_fusion_tpu ops/quant.py, the quantizers of
ops/pallas/conv_int8.py:37-137 and the chain rules of
ops/pallas/hiw_int8.py:52-107).

Scheme, as the JAX package's: symmetric max-abs; weights per output channel;
activations per input channel on a smooth fold `f` (SmoothQuant-style,
`choose_fold`) that is folded into the weights before they are quantized,
so the integer dot's channel scales cancel and the dequant is the
per-output-channel weight scale alone. Calibration runs a few batches
through the float model and records, for every ConvLayer, the
per-input-channel max |x| of its effective input (a list of legs: their
channel concat; a fuse_n layer: the siamese sum; a depthwise layer: its
window plus the added group), max-reduced across batches and keyed by the
JAX package's '/'-joined flax path (`utils/jax_convert.flax_paths`), so
an amax dict and `MMIF_INT8_SKIP` entries mean the same in both packages.

    amax = calibrate(model, [(img1, img2), ...])
    with quantized_inference(amax):
        y = model(img1, img2)

Inside the context an eligible ConvLayer (stride 1, ungrouped, not
skipped) runs ops/cuda/conv_int8.conv_int8 (ops/layers.py); DeepFuse runs
its int8 chain (models/zoo.py) on conv_int8_chain. A layer with no
calibrated amax quantizes on the dynamic per-channel max of its input.
The weights and fold of a calibrated layer are prepared once per context
(`quantized_inference.cached`).

Environment switches read here, as the JAX package reads them:
`MMIF_INT8_SKIP` (comma-separated layers kept in float: a name without '/'
matches a path's last component, one with '/' the whole path),
`MMIF_INT8_ALPHA` and `MMIF_INT8_CLIP` (choose_fold's alpha and amax
clip), `MMIF_INT8_FOLD` (the fold mode of the ConvLayer route),
`MMIF_HIW_INT8` (0: DeepFuse takes the ConvLayer route too) and
`MMIF_HIW_INT8_RES` (0: no int8-resident hops in DeepFuse's chain).
"""

import contextlib
import contextvars
import os

import numpy as np
import torch

__all__ = ["DEFAULT_INT8_SKIP", "calibrate", "calibrating", "chain_hop_ok",
           "chain_leg_ok", "choose_fold", "default_skip", "fold_weights",
           "hiw_fold_scale", "hiw_int8_enabled", "hiw_res_enabled",
           "name_layers", "quant_ctx", "quant_off", "quant_skipped",
           "quantize_input_recip", "quantize_input_scaled",
           "quantize_weights", "quantized_inference", "record"]

_QUANT_CTX = contextvars.ContextVar("mmif_quant", default=None)
_CALIB = contextvars.ContextVar("mmif_calib", default=None)

# Per-model layers kept in float (the JAX package's measured defaults,
# ops/quant.py:54): none.
DEFAULT_INT8_SKIP = {}


def default_skip(model_name):
    """The measured skip tuple for a model (empty if none known)."""
    return DEFAULT_INT8_SKIP.get(str(model_name).lower(), ())


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------


class quantized_inference:
    """Context manager activating the int8 inference path.

    amax: {"enc1": (C_in,) array, ...} keyed by '/'-joined flax paths as
    `calibrate` returns them; an empty dict is allowed (every layer then
    quantizes on the dynamic max of its input). skip: layer names kept in
    float, matched as `quant_skipped` says."""

    def __init__(self, amax=None, skip=()):
        self.amax = dict(amax or {})
        self.skip = tuple(skip)
        self._cache = {}

    def cached(self, key, make):
        """make() once per key for the life of this context: the folded and
        quantized weights of a calibrated layer."""
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def __enter__(self):
        self._tok = _QUANT_CTX.set(self)
        return self

    def __exit__(self, *exc):
        _QUANT_CTX.reset(self._tok)
        return False


def quant_ctx():
    """The active quantized_inference, or None."""
    return _QUANT_CTX.get()


@contextlib.contextmanager
def quant_off():
    """Suspend the int8 context: DeepFuse's chain runs its float legs
    through the float serving kernels, as the JAX chain runs them on
    conv_hiw_chain."""
    token = _QUANT_CTX.set(None)
    try:
        yield
    finally:
        _QUANT_CTX.reset(token)


def quant_skipped(path):
    """True if the layer at `path` ('/'-joined flax path) stays in float:
    named by the active context's skip set or by MMIF_INT8_SKIP (comma-
    separated; the variable adds to the context's set). An entry without
    '/' matches the path's last component, one with '/' the whole path
    (JAX ops/quant.py:67-91)."""
    if not path:
        return False
    qc = _QUANT_CTX.get()
    names = set(qc.skip if qc is not None else ())
    env = os.environ.get("MMIF_INT8_SKIP")
    if env:
        names.update(env.split(","))
    leaf = path.rsplit("/", 1)[-1]
    return any(("/" in n and path == n) or ("/" not in n and leaf == n)
               for n in names)


def hiw_int8_enabled():
    """MMIF_HIW_INT8 (default on): DeepFuse runs its int8 chain under the
    context; 0 sends it to the ConvLayer route on all five layers."""
    return os.environ.get("MMIF_HIW_INT8", "1") != "0"


def hiw_res_enabled():
    """MMIF_HIW_INT8_RES (default on): int8-resident hops in DeepFuse's
    chain (JAX ops/pallas/hiw_int8.py:99)."""
    return os.environ.get("MMIF_HIW_INT8_RES", "1") != "0"


def chain_leg_ok(c_in, c_out):
    """Which of DeepFuse's chain legs run int8: c_in a multiple of 8 and
    more than one output channel. At DeepFuse's widths this admits what
    the JAX gate hiw_q_ok admits (enc1, dec0, dec1) and keeps the gray
    entry (c_in 1) and exit (c_out 1) in float; the TPU's alignment
    arithmetic behind that gate has no counterpart here."""
    return c_in % 8 == 0 and c_out > 1


def chain_hop_ok(producer_act):
    """An int8-resident hop between two int8 legs needs a producer act of
    None or relu: the requant folds the consumer's positive 1/f into the
    dequant and the bias, which commutes with those two only (JAX
    hiw_int8.py:320, zoo.py:440-441)."""
    return producer_act in (None, "relu")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def name_layers(model):
    """Give every ConvLayer of a ported zoo model its flax path (`qpath`),
    the key calibration and the skip set use."""
    from ..models.zoo import MODEL_ZOO
    from ..utils.jax_convert import flax_paths
    from .layers import ConvLayer
    names = {cls: name for name, cls in MODEL_ZOO.items()}
    paths = flax_paths(names[type(model)], **getattr(model, "layout_cfg", {}))
    for prefix, m in model.named_modules():
        if isinstance(m, ConvLayer):
            if prefix not in paths:
                raise ValueError(f"{type(model).__name__}.{prefix} has no "
                                 f"flax path in utils/jax_convert")
            m.qpath = paths[prefix]
    return model


def calibrating():
    """True inside `calibrate`'s forwards."""
    return _CALIB.get() is not None


def record(path, x):
    """During calibration: fold the per-channel max |x| of an NHWC input
    into the layer's entry. A no-op otherwise."""
    stats = _CALIB.get()
    if stats is None:
        return
    a = x.detach().abs().amax(dim=(0, 1, 2)).float()
    prev = stats.get(path)
    stats[path] = a if prev is None else torch.maximum(prev, a)


def calibrate(model, batches):
    """Per-ConvLayer, per-input-channel max |x| over calibration batches
    (tuples of model arguments: (img1, img2), or (img1,) in autoencoder
    mode), through the float forward. Returns {flax path: (C_in,) float32
    ndarray} (JAX ops/quant.py:119-149)."""
    name_layers(model)
    stats = {}
    token = _CALIB.set(stats)
    try:
        with quant_off(), torch.no_grad():
            for batch in batches:
                model(*batch)
    finally:
        _CALIB.reset(token)
    return {k: v.cpu().numpy().astype(np.float32) for k, v in stats.items()}


# ---------------------------------------------------------------------------
# quantizers (OIHW weights, NHWC activations)
# ---------------------------------------------------------------------------


def quantize_weights(w):
    """OIHW float -> (int8 OIHW, per-output-channel scale (C_out,) f32):
    amax / 127, round half to even, clip to +-127."""
    w = w.float()
    amax = w.abs().amax(dim=(1, 2, 3))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale.view(-1, 1, 1, 1)), -127, 127)
    return q.to(torch.int8), scale


def choose_fold(amax, w, mode="smooth", alpha=None, clip=None):
    """Per-input-channel activation scale f (C_in,) f32 for OIHW weights w,
    consistent with folding the same f into w (JAX conv_int8.py:60-126):

      'channel'  f_c = amax_c / 127
      'tensor'   f_c = max_c amax_c / 127
      'smooth'   f_c = beta * (amax_c / wmax_c) ** alpha, beta the smallest
                 value keeping every channel clip-free

    Dead channels (amax or wmax 0) get the per-tensor g. alpha and clip
    default to MMIF_INT8_ALPHA (0.5) and MMIF_INT8_CLIP (1.0); clip scales
    the amax before the fold."""
    if alpha is None:
        alpha = float(os.environ.get("MMIF_INT8_ALPHA", "0.5"))
    if clip is None:
        clip = float(os.environ.get("MMIF_INT8_CLIP", "1.0"))
    amax = torch.as_tensor(amax, dtype=torch.float32,
                           device=w.device) * clip
    wmax = w.float().abs().amax(dim=(0, 2, 3))
    live = (amax > 0) & (wmax > 0)
    g = amax.max() / 127.0
    g = torch.where(g > 0, g, torch.ones_like(g))
    if mode == "channel":
        return torch.where(amax > 0, amax / 127.0, g)
    if mode == "tensor":
        return g.expand_as(amax).clone()
    if mode != "smooth":
        raise ValueError(f"unknown fold mode {mode!r}")
    ratio = _pow(amax / torch.where(live, wmax, torch.ones_like(wmax)),
                 alpha)
    beta = torch.where(live, _pow(amax, 1.0 - alpha) * _pow(wmax, alpha),
                       torch.zeros_like(amax)).max() / 127.0
    return torch.where(live, beta * ratio, g)


def _pow(x, a):
    """x ** a in f64, rounded once to f32: nearer XLA's f32 pow than torch's
    vectorised f32 pow and sqrt on the CPU, which miss the correctly
    rounded value now and then (the fold then matches the JAX package's
    within an ulp or two)."""
    xd = x.double()
    return (torch.sqrt(xd) if a == 0.5 else xd ** a).float()


def hiw_fold_scale(amax, w):
    """The fold the consumer of an int8-resident hop applies: a producer
    requantizes its output onto exactly this grid (JAX hiw_int8.py:91)."""
    return choose_fold(amax, w, "smooth")


def fold_weights(w, f):
    """w * f_c along the input channels of OIHW w, in f32."""
    return w.float() * f.float().view(1, -1, 1, 1)


def quantize_input_scaled(x, f):
    """NHWC float -> int8 by round(x / f), a division (the ConvLayer
    route's quantizer, JAX conv_int8.py:136)."""
    return torch.clamp(torch.round(x.float() / f.float()), -127,
                       127).to(torch.int8)


def quantize_input_recip(x, invf):
    """NHWC float -> int8 by round(x * (1/f)), a multiply by the reciprocal
    (the chain's in-kernel quantizer, JAX hiw_int8.py:215-217); it differs
    from the division by one quantum now and then."""
    return torch.clamp(torch.round(x.float() * invf.float()), -127,
                       127).to(torch.int8)
