"""Weight carry from the JAX package's variables to the port's state dict:
the inverse of multi_modal_image_fusion_tpu utils/torch_convert.py
(`_conv_w` :27, `_conv`/`_seq` :54-75, `_res_block` :79-85, `_dense_block`
:88-89, `_conv_block` :92-95, `_rfn` :98-106, `_res2_block` :109-119,
`_nest_decoder` :223-225, the DeepFuse, DenseFuse, VIFNet, DBNet, IFCNN,
DIFNet, PFNetv1, PFNetv2, PMGI, Res2Fusion, NestFuse, RFNNest, MAFusion,
UNFusion and SEDRFuse mappings :365-393 and :395-478, MyFusion's
:280-342 `convert_myfusion`, a function of its configuration, and the
blocks of `convert_block` :200-241, `jax_block_to_state_dict`).

Input is the JAX variables as a nested dict of numpy arrays, to any depth,
`{"params": {"enc0": {"kernel": HWIO, "bias": ...}, ...}, "batch_stats":
{"enc1": {"norm": {"mean": ..., "var": ...}}, ...}}` (e.g. from
`flax.serialization.msgpack_restore` of a JAX checkpoint), and for
MyFusion its configuration (`model.layout_cfg`: encoder, decoder,
fusion_method, share_weight_levels, norm). Output is a
`{name: torch.Tensor}` state dict with the reference names and OIHW conv
weights (IOHW for a transpose conv: SEDRFuse's dec0 and dec1, the inverse
of `_deconv_w` :31); a norm's scale and bias become `layers.1.weight` and
`bias`, a batch norm's statistics `running_mean` and `running_var`, and
its `num_batches_tracked` is 0 (SEDRFuse's group norms have no
statistics); a ConvLayer's channel layer norm's scale becomes
`layers.1.weight` of shape (C, 1, 1). The MetaFormer blocks' standalone
norms (`norm1`, `norm2`: a batch norm's scale, bias and statistics, a
layer norm's scale as (C, 1, 1)) and scales (`layer_scale1.scale`, ...)
carry under their own names. Conversion fails loudly if a JAX leaf, of
the params or of the batch statistics, is left unused.

`jax_train_state_to_torch` carries a whole JAX TrainState (train/trainer.py:
29: step, params, batch_stats, and the optax chain's state with Adam's
mu, nu and count) to the port's state dict and the port Trainer's
optimizer state (`Trainer.load_state_dict`).
"""

import numpy as np
import torch

__all__ = ["flax_paths", "jax_block_to_state_dict", "jax_to_state_dict",
           "jax_train_state_to_torch"]


def _res2_block(name, scale):
    """A Res2ConvBlock's convs (their biases absent: use_bias=False); the
    dead `dwconv` set is carried too."""
    return {f"{name}/{conv}": f"{name}.{conv}"
            for conv in ("pwconv1", "dwconv", "pwconv2", "shortcut")} | {
        f"{name}/dwconv{i}": f"{name}.dwconvs.{i}" for i in range(scale)}


def _dense_block(name, prefix):
    return {f"{name}/conv{i}": f"{prefix}.layers.{i}" for i in range(3)}


def _conv_block(name, prefix):
    """ConvBlock / ECB / DCB: conv1, conv2 -> layers.0, layers.1."""
    return {f"{name}/conv{i + 1}": f"{prefix}.layers.{i}" for i in range(2)}


def _unfusion():
    """UNFusion in stride mode (maxpool mode has no down convs: their
    entries are skipped when the JAX tree lacks them)."""
    m = {"conv_out": "conv_out",
         **{f"CB{i}_0": f"CB{i}_0" for i in range(1, 5)},
         **{f"down{i}": f"down{i}" for i in (1, 2, 3)},
         **{f"encode/down{i}": f"encode.down{i}" for i in (1, 2, 3)}}
    for n in ("EB2_1", "EB3_1", "EB4_1", "EB3_2", "EB4_2", "EB4_3"):
        m |= _conv_block(f"encode/{n}", f"encode.{n}")
    for n in ("DB1_1", "DB2_1", "DB3_1", "DB1_2", "DB2_2", "DB1_3"):
        m |= _conv_block(f"decode/{n}", f"decode.{n}")
    return m


def _rfn(name):
    """An RFN: res, conv1, conv2 keep their names, fuse1-3 -> layers.0-2."""
    return {f"{name}/{conv}": f"{name}.{conv}"
            for conv in ("res", "conv1", "conv2")} | {
        f"{name}/fuse{i + 1}": f"{name}.layers.{i}" for i in range(3)}


def _nest(decoder_blocks, rfn=False):
    """NestFuse, RFNNest and MAFusion in stride mode (maxpool mode has no
    down convs: their entries are skipped when the JAX tree lacks them)."""
    m = {"conv_in": "conv_in", "conv_out": "conv_out",
         **{f"down{i}": f"down{i}" for i in (1, 2, 3)}}
    for i in range(1, 5):
        m |= _conv_block(f"CB{i}_0", f"CB{i}_0")
        if rfn:
            m |= _rfn(f"RFN{i}")
    for n in decoder_blocks:
        m |= _conv_block(f"decode/{n}", f"decode.{n}")
    return m


_NEST_DECODER = ("DB1_1", "DB2_1", "DB3_1", "DB1_2", "DB2_2", "DB1_3")


def _res_block(name, prefix):
    """ResBlock: flax ConvLayer_0, ConvLayer_1 -> layers.0, layers.1."""
    return {f"{name}/ConvLayer_{i}": f"{prefix}.layers.{i}" for i in range(2)}


def _pmgi():
    m = {"decode": "decode"}
    for i in range(4):
        m[f"gradient{i}"] = f"gradient.{i}"
        m[f"intensity{i}"] = f"intensity.{i}"
    for i in range(2):
        m[f"transfer1_{i}"] = f"transfer1.{i}"
        m[f"transfer2_{i}"] = f"transfer2.{i}"
    return m

# flax submodule path -> reference state-dict prefix, per ported model
_DENSE_ENCODER = {"conv_in": "encode.0", **_dense_block("dense", "encode.1")}
_DOWNS = {f"down{i}" for i in (1, 2, 3)}
_OPTIONAL = {"unfusion": _DOWNS | {f"encode/{d}" for d in _DOWNS},
             "nestfuse": _DOWNS, "rfnnest": _DOWNS, "mafusion": _DOWNS}


def _j(a, b, sep):
    """Join a parent path (empty for a block alone) and a child name."""
    return f"{a}{sep}{b}" if a else b


def _block(kind, flax, port):
    """The layout of one encoder block under flax path `flax` and port
    prefix `port` (both empty for a block alone): (layout, optional
    paths). A layout value is a ConvLayer's prefix, or (kind, prefix) for
    a standalone leaf set: a MetaFormer's norms ('batch', 'layer') and
    scales ('scale'). A Sep, Mix or Res2 block is MyFusion's: in_ch ==
    out_ch (no k1 shortcut), no attention gate. Optional: the avgpool
    Attention's pool, and a MetaFormer's scales (present only when
    set)."""
    def f(name):
        return _j(flax, name, "/")

    def t(name):
        return _j(port, name, ".")
    if kind in ("sep", "mix", "res2"):
        m = {f(c): t(c) for c in ("pwconv1", "dwconv", "pwconv2")}
        if kind != "sep":
            m |= {f(f"dwconv{i}"): t(f"dwconvs.{i}") for i in range(4)}
        return m, set()
    if kind == "attention":
        m = {f(c): t(c) for c in ("q", "k", "v", "proj", "pool")}
        return m, {f("pool")}
    if kind == "ffn":
        return {f(c): t(f"layers.{i}")
                for i, c in enumerate(("pw1", "dw", "pw2"))}, set()
    mixer = {"conv_former": "sep", "mix_former": "mix",
             "res2_former": "res2", "transformer": "attention",
             "metaformer": None}[kind]
    norm = "layer" if kind == "metaformer" else "batch"
    m, optional = _block("ffn", f("ffn"), t("ffn"))
    if mixer is not None:
        mm, mo = _block(mixer, f("token_mixer"), t("token_mixer"))
        m |= mm
        optional |= mo
    for n in ("norm1", "norm2"):
        m[f(n)] = (norm, t(n))
    for n in ("layer_scale1", "res_scale1", "layer_scale2", "res_scale2"):
        m[f(n)] = ("scale", t(n))
        optional.add(f(n))
    return m, optional


def _myfusion(encoder="sep", decoder="nest", fusion_method="attn",
              share_weight_levels=4, norm=None):
    """MyFusion's layout for a configuration (the inverse of JAX
    utils/torch_convert.py:280 convert_myfusion): conv_in_1 (and conv_in_2
    below share_weight_levels 4), each level's TransitionBlock (dw, pw ->
    layers.0, layers.1) and encoder block (`_block`) per branch that has
    its own, the fusion's convs (fuse1-4, or RFN1-4), the decoder's
    DCBlocks (pw1, dw, pw2 -> layers.0-2), conv_out. Optional: the maxpool
    mode's missing dw at levels 2-4, and each block's. Returns (layout,
    optional paths, the ConvLayers' norm kind)."""
    enc = [encoder] * 4 if isinstance(encoder, str) else list(encoder)
    split = 4 - share_weight_levels
    m = {"conv_in_1": "conv_in_1", "conv_out": "conv_out"}
    if split:
        m["conv_in_2"] = "conv_in_2"
    optional = set()
    for lv in range(1, 5):
        for br in (1, 2) if lv <= split else (1,):
            d, eb = f"down{lv}_{br}", f"EB{lv}_{br}"
            m |= {f"{d}/dw": f"{d}.layers.0", f"{d}/pw": f"{d}.layers.1"}
            if lv > 1:
                optional.add(f"{d}/dw")
            bm, bo = _block(enc[lv - 1], eb, eb)
            m |= bm
            optional |= bo
    for i in range(1, 5):
        if fusion_method == "concat":
            m[f"fuse{i}"] = f"fuse{i}"
        elif fusion_method == "rfn":
            m |= _rfn(f"RFN{i}")
    for n in _NEST_DECODER if decoder == "nest" else ("DB1", "DB2", "DB3"):
        m |= {f"decode/{n}/{conv}": f"decode.{n}.layers.{i}"
              for i, conv in enumerate(("pw1", "dw", "pw2"))}
    return m, optional, norm


_LAYOUTS = {
    "deepfuse": {"enc0": "encode.0", "enc1": "encode.1", "dec0": "decode.0",
                 "dec1": "decode.1", "dec2": "decode.2"},
    "densefuse": {**_DENSE_ENCODER,
                  **{f"dec{i}": f"decode.{i}" for i in range(4)}},
    "vifnet": {**_DENSE_ENCODER,
               **{f"dec{i}": f"decode.{i}" for i in range(5)}},
    "res2fusion": {"conv_in": "conv_in",
                   **_res2_block("RB1", 4), **_res2_block("RB2", 8),
                   **{f"dec{i}": f"decode.{i}" for i in range(4)}},
    "dbnet": {"conv_in": "encode", "detail0": "detail.0",
              **_dense_block("detail1", "detail.1"),
              **{f"semantic{i}": f"semantic.{i}" for i in range(3)},
              **{f"dec{i}": f"decode.{i}" for i in range(4)}},
    "unfusion": _unfusion(),
    "nestfuse": _nest(_NEST_DECODER),
    "rfnnest": _nest(_NEST_DECODER, rfn=True),
    "mafusion": _nest(("DB1", "DB2", "DB3")),
    "ifcnn": {"enc0": "encode.0", "enc1": "encode.1", "dec0": "decode.0",
              "dec1": "decode.1"},
    "difnet": {"enc0": "encode.0", **_res_block("enc1", "encode.1"),
               **_res_block("enc2", "encode.2"), "fuse": "fuse",
               **{k: v for i in range(3)
                  for k, v in _res_block(f"dec{i}", f"decode.{i}").items()},
               "dec3": "decode.3"},
    "pmgi": _pmgi(),
    "pfnetv1": {"conv_in_1": "encode1.0", "conv_in_2": "encode2.0",
                **_dense_block("dense_1", "encode1.1"),
                **_dense_block("dense_2", "encode2.1"),
                **{f"decode{i}": f"decode.{i}" for i in range(5)}},
    "pfnetv2": {**_DENSE_ENCODER,
                **{f"fuse{i}": f"fuse.{i}" for i in range(3)},
                **{f"decode{i}": f"decode.{i}" for i in range(4)}},
    "sedrfuse": {"enc0": "encode.0", "enc1": "encode.1", "enc2": "encode.2",
                 **_res_block("res", "encode.3"), "dec0": "decode.0",
                 "dec1": "decode.1", "dec2": "decode.2"},
}


# the models whose ConvLayers' norms are group norms (params only), and
# their transpose convs (flax HWIO (3, 3, I, O) -> torch IOHW)
_GROUP_NORMED = {"sedrfuse"}
_TRANSPOSED = {"sedrfuse": {"dec0", "dec1"}}


def _layout(model_name, cfg):
    """(flax path -> state-dict prefix, optional flax paths, the kind of
    the ConvLayers' norms: 'group' or 'layer' (params only), else batch
    norms) of a model; `cfg` is MyFusion's configuration
    (`MyFusion.layout_cfg`), and no other model takes one."""
    name = model_name.lower()
    if name == "myfusion":
        return _myfusion(**cfg)
    if name not in _LAYOUTS:
        raise NotImplementedError(f"no layout for {model_name!r} yet")
    if cfg:
        raise ValueError(f"a model configuration applies to 'myfusion' "
                         f"only, not {model_name!r}")
    return (_LAYOUTS[name], _OPTIONAL.get(name, set()),
            "group" if name in _GROUP_NORMED else None)


def flax_paths(model_name, **cfg):
    """{port module name: '/'-joined flax path} of a model's conv layers,
    the inverse of its layout: the keys int8 calibration records under
    (ops/quant.py), as the JAX package's `calibrate` does."""
    return {prefix: path
            for path, prefix in _layout(model_name, cfg)[0].items()
            if isinstance(prefix, str)}


def _oihw(kernel_hwio):
    return np.ascontiguousarray(np.transpose(kernel_hwio, (3, 2, 0, 1)))


def _iohw(kernel_hwio):
    return np.ascontiguousarray(np.transpose(kernel_hwio, (2, 3, 0, 1)))


def jax_to_state_dict(variables, model_name="deepfuse", strict=True, **cfg):
    """JAX variables (nested numpy dict) -> port state dict (torch); `cfg`
    MyFusion's configuration (`MyFusion.layout_cfg`). strict=False (a
    checkpoint restore's merge): a layer the variables lack is left out
    and the flax paths the layout does not take are returned beside the
    state dict, (state dict, [path, ...]), where strict raises."""
    name = model_name.lower()
    layout, optional, norm_kind = _layout(name, cfg)
    if not strict:
        optional = set(layout)
    return _convert(variables, layout, optional, norm_kind,
                    _TRANSPOSED.get(name, ()), strict)


def jax_block_to_state_dict(variables, kind):
    """The JAX variables of one encoder block alone -> the port block's
    state dict: kind 'sep', 'mix', 'res2' (SepConvBlock, MixConvBlock,
    Res2ConvBlock, in_ch == out_ch and no attention gate),
    'attention', 'ffn', 'metaformer' (MetaFormerBlock with its default
    layer norms) or a Former ('conv_former', 'mix_former', 'res2_former',
    'transformer')."""
    layout, optional = _block(kind, "", "")
    return _convert(variables, layout, optional, None, ())


def _convert(variables, layout, optional, norm_kind, transposed, strict=True):
    params = _copy_tree(variables["params"])
    stats = _copy_tree(variables.get("batch_stats", {}))
    sd = {}
    for flax_path, prefix in layout.items():
        *outer, flax_name = flax_path.split("/")
        parent = params
        for key in outer:
            parent = parent.get(key, {})
        if flax_name not in parent and flax_path in optional:
            continue
        leaf = parent.pop(flax_name)
        if isinstance(prefix, tuple):
            sd.update(_standalone(leaf, stats, flax_path, *prefix))
            continue
        to_torch = _iohw if flax_path in transposed else _oihw
        sd[f"{prefix}.layers.0.weight"] = torch.from_numpy(
            to_torch(np.asarray(leaf.pop("kernel"), np.float32)))
        if "bias" in leaf:
            sd[f"{prefix}.layers.0.bias"] = torch.from_numpy(
                np.array(leaf.pop("bias"), np.float32))
        if "norm" in leaf and norm_kind == "group":
            sd.update(_group_norm(leaf.pop("norm"), flax_path,
                                  f"{prefix}.layers.1"))
        elif "norm" in leaf and norm_kind == "layer":
            sd.update(_layer_norm(leaf.pop("norm"), flax_path,
                                  f"{prefix}.layers.1"))
        elif "norm" in leaf:
            sd.update(_batch_norm(leaf.pop("norm"), stats, flax_path,
                                  f"{prefix}.layers.1"))
        if leaf:
            raise ValueError(f"unconverted leaves under {flax_name}: "
                             f"{sorted(leaf)}")
    left = _leaf_paths(params)
    if not strict:
        return sd, left + [f"batch_stats/{p}" for p in _leaf_paths(stats)]
    if left:
        raise ValueError(f"unconverted JAX params: {left}")
    left = _leaf_paths(stats)
    if left:
        raise ValueError(f"unconverted JAX batch_stats: {left}")
    return sd


def _standalone(leaf, stats, flax_path, kind, prefix):
    """A MetaFormer's standalone leaf set: a batch norm (its statistics
    directly under its flax path in `stats`), a layer norm or a scale."""
    if kind == "batch":
        return _batch_norm(leaf, stats, flax_path, prefix, stats_name=None)
    if kind == "layer":
        return _layer_norm(leaf, flax_path, prefix)
    out = {f"{prefix}.scale": torch.from_numpy(np.array(leaf.pop("scale"),
                                                        np.float32))}
    if leaf:
        raise ValueError(f"unconverted leaves under {flax_path}: "
                         f"{sorted(leaf)}")
    return out


def _batch_norm(norm, stats, flax_path, prefix, stats_name="norm"):
    """A batch norm's params (scale, bias) and its statistics in `stats`
    (mean, var; popped) under the same flax path, then `stats_name` (a
    ConvLayer's 'norm'; None for a standalone norm, whose statistics sit at
    its own path) -> the BatchNorm2d state dict entries under `prefix`."""
    *outer, last = flax_path.split("/")
    parent = stats
    for key in outer if stats_name is None else [*outer, last]:
        parent = parent.get(key, {})
    st = parent.pop(stats_name or last, None) if parent else None
    if st is None:
        raise ValueError(f"no batch_stats for the norm of {flax_path}")
    out = {f"{prefix}.{dst}": torch.from_numpy(np.array(tree.pop(src),
                                                        np.float32))
           for tree, src, dst in ((norm, "scale", "weight"),
                                  (norm, "bias", "bias"),
                                  (st, "mean", "running_mean"),
                                  (st, "var", "running_var"))}
    if norm or st:
        raise ValueError(f"unconverted norm leaves under {flax_path}: "
                         f"{sorted(norm) + sorted(st)}")
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return out


def _layer_norm(norm, flax_path, prefix):
    """A channel layer norm's scale -> its `weight` (C, 1, 1) under
    `prefix` (the reference's shape)."""
    w = np.array(norm.pop("scale"), np.float32)
    if norm:
        raise ValueError(f"unconverted norm leaves under {flax_path}: "
                         f"{sorted(norm)}")
    return {f"{prefix}.weight": torch.from_numpy(w.reshape(-1, 1, 1))}


def _group_norm(norm, flax_path, prefix):
    """A group norm's params (scale, bias) -> GroupNorm's state dict
    entries under `prefix`."""
    out = {f"{prefix}.{dst}": torch.from_numpy(np.array(norm.pop(src),
                                                        np.float32))
           for src, dst in (("scale", "weight"), ("bias", "bias"))}
    if norm:
        raise ValueError(f"unconverted norm leaves under {flax_path}: "
                         f"{sorted(norm)}")
    return out


def _copy_tree(tree):
    """The nested dicts of a JAX tree copied (the arrays shared)."""
    return {k: _copy_tree(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


def _leaf_paths(tree, prefix=""):
    """Slash-joined paths of the arrays left in a nested dict."""
    out = []
    for k, v in sorted(tree.items()):
        path = f"{prefix}{k}"
        out += (_leaf_paths(v, path + "/") if hasattr(v, "items")
                else [path])
    return out


def jax_train_state_to_torch(state, model_name="deepfuse", **cfg):
    """A JAX TrainState as a nested dict of numpy arrays (e.g.
    `flax.serialization.msgpack_restore` of a JAX `epoch_last.ckpt`) ->
    (port state dict, port optimizer state {"step", "mu", "nu"}); `cfg`
    MyFusion's configuration, as for `jax_to_state_dict`.

    The batch statistics (a model with batch norms) become the norms'
    `running_mean` and `running_var` through the serving carry's layouts;
    `num_batches_tracked`, which the JAX package does not count, is 0. The
    optax chain's state is a dict of its transforms' states ("0", "1",
    ...): one Adam state (count, mu, nu), optional schedule states (count)
    and empty clip states. Every count and the step must agree; any other
    leaf raises."""
    state = dict(state)
    step = int(np.asarray(state.pop("step")))
    params = state.pop("params")
    stats = state.pop("batch_stats", None) or {}
    opt = state.pop("opt_state")
    if state:
        raise ValueError(f"unconverted TrainState fields: {sorted(state)}")
    adam, counts = None, []
    for key in sorted(opt):
        entry = dict(opt[key])
        if "mu" in entry or "nu" in entry:
            if adam is not None:
                raise ValueError("more than one Adam state in opt_state")
            adam = entry
        elif set(entry) == {"count"}:
            counts.append(int(np.asarray(entry.pop("count"))))
        elif entry:
            raise ValueError(f"unconverted optimizer state {key}: "
                             f"{sorted(entry)}")
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in opt_state")
    counts.append(int(np.asarray(adam.pop("count"))))

    def carry(tree):
        return jax_to_state_dict({"params": tree, "batch_stats": stats},
                                 model_name, **cfg)
    sd = carry(params)
    buffers = {k for k in sd if k.rsplit(".", 1)[-1] in (
        "running_mean", "running_var", "num_batches_tracked")}
    mu, nu = ({k: v for k, v in carry(adam.pop(key)).items()
               if k not in buffers} for key in ("mu", "nu"))
    if adam:
        raise ValueError(f"unconverted Adam leaves: {sorted(adam)}")
    if any(c != step for c in counts):
        raise ValueError(f"optimizer counts {counts} differ from step {step}")
    return sd, {"step": step, "mu": mu, "nu": nu}
