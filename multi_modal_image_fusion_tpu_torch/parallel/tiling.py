"""Single-card height tiling: recompute traded for activation memory
(counterpart of multi_modal_image_fusion_tpu parallel/tiling.py).

The forward of one (batch of) pair(s) runs as a loop over height slabs,
so only one slab's activations are live at a time; each interior slab
recomputes 2R overlap rows. The slabs' output rows equal the whole-image
forward's. Two regimes:

1. Whole-model slabs (the stride-1 local-fusion models of
   spatial.SPATIAL_ELIGIBLE): the unchanged forward on each slab with R =
   `receptive_halo(model)` context rows on each inner side; the halo rows
   are discarded. The top and bottom slabs keep the image's own edges, so
   their reflect padding is the whole image's.
2. Two phases (the multi-scale and global-fusion models of
   TILED_MULTISCALE), whose fusion reduces over the whole image (global
   channel pooling of 'sca' and 'wavg', the non-local 'nl' attention):
   a. tiled encode: `model.encoder` on each slab of the batch-concatenated
      pair (2B images), its per-scale features cropped to the slab's own
      rows and stitched into whole pyramids;
   b. the model's `fusion` on the whole pyramids, so its statistics are
      the whole image's;
   c. tiled decode: `model.decode_feats` on each slab's rows of the fused
      pyramids. A bilinear align_corners upsample weights rows by the
      whole image's geometry, so both tiled phases run inside
      ops/layers.tile_rows_ctx.
   Slab boundaries and halos are multiples of 8 full-resolution rows, so
   every pool window, stride-2 conv and x2/x4/x8 upsample stays aligned at
   every scale.

Models in neither set (SEDRFuse's cross-phase skips, DBNet, MyFusion, a
global fusion mode) raise. The slabs, contiguous copies of their rows
(the kernels read contiguous NHWC tensors), run through the model's own
serving routes, so on the card every conv of a slab is a kernel launch; a
slab a kernel refuses raises there, as a whole image of that height
would.
"""

import torch

from ..ops.layers import tile_rows_ctx
from .spatial import check_spatial_eligible, receptive_halo

__all__ = ["TILED_MULTISCALE", "receptive_halo", "tiled_forward"]

# model name -> (encode halo, decode halo) in full-resolution rows, the
# JAX package's table (tiling.py:63-69): receptive-field upper bounds over
# the worst conv path, (k // 2) times its scale plus the scale of each
# bilinear tap, rounded up to a multiple of 8
TILED_MULTISCALE = {
    "nestfuse": (16, 16),
    "rfnnest": (16, 16),
    "mafusion": (16, 24),
    "unfusion": (48, 48),
    "res2fusion": (16, 8),
}


def tiled_forward(model, img1, img2, n_tiles, halo=None):
    """model(img1, img2) computed in `n_tiles` sequential height slabs.

    img1, img2: (B, H, W, 1). Returns the fused output of the whole-image
    forward. `halo` overrides the receptive halo (both phases' for the
    multi-scale models)."""
    n = int(n_tiles)
    if n <= 1:
        return model(img1, img2)
    name = type(model).__name__.lower()
    if name in TILED_MULTISCALE:
        enc_rh, dec_rh = (TILED_MULTISCALE[name] if halo is None
                          else (int(halo), int(halo)))
        return _two_phase(model, img1, img2, n, enc_rh, dec_rh)
    check_spatial_eligible(name, getattr(model, "fusion_mode", None))
    return _whole_model(model, img1, img2, n, halo)


def _check_divisible(h, n):
    if h % n:
        raise ValueError(f"H={h} not divisible by n_tiles={n}; pad the "
                         f"input (cli pad_bucket) or use fewer tiles")


def _slab_geometry(h, n, rh):
    _check_divisible(h, n)
    s = h // n
    if s % 8 or rh % 8:
        raise ValueError(
            f"slab height {s} and halo {rh} must be multiples of 8 "
            f"(scale/pool alignment); pad H={h} or change n_tiles={n}")
    if s < rh:
        # an interior slab's halo window would cross the true image
        # boundary, where its reflect padding is not at the real edge
        raise ValueError(
            f"slab height {s} < receptive halo {rh}: use fewer tiles "
            f"for H={h}")
    return s


def _windows(h, n, s, r):
    """(lo, hi, keep_lo) of each slab: its input rows [lo, hi) and the
    first of its rows kept (the next s rows are the output's rows [i * s,
    (i + 1) * s))."""
    out = [(0, s + r, 0)]
    out += [(i * s - r, (i + 1) * s + r, r) for i in range(1, n - 1)]
    out.append((h - (s + r), h, r))
    return out


def _whole_model(model, img1, img2, n, halo):
    h = img1.shape[1]
    _check_divisible(h, n)
    s = h // n
    r = receptive_halo(model) if halo is None else int(halo)
    if s < r:
        raise ValueError(
            f"slab height {s} < receptive halo {r}: context would span "
            f"non-neighbor slabs; use fewer tiles for H={h}")
    out = None
    for i, (lo, hi, keep) in enumerate(_windows(h, n, s, r)):
        y = model(img1[:, lo:hi].contiguous(),
                  img2[:, lo:hi].contiguous())[:, keep:keep + s]
        if out is None:
            out = y.new_empty((y.shape[0], h, *y.shape[2:]))
        out[:, i * s:(i + 1) * s] = y
        del y
    return out


def _map(fn, tree):
    """fn over the tensors of a tensor, or of a list or tuple of them."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(fn(t) for t in tree)
    return fn(tree)


def _leaves(tree):
    return list(tree) if isinstance(tree, (list, tuple)) else [tree]


def _scale(f, slab_h):
    sc = slab_h // f.shape[1]
    if f.shape[1] * sc != slab_h:
        raise ValueError(
            f"encoder feature height {f.shape[1]} does not divide slab "
            f"height {slab_h}: non-uniform scale transition")
    return sc


def _two_phase(model, img1, img2, n, enc_rh, dec_rh):
    b, h = img1.shape[:2]
    s = _slab_geometry(h, n, max(enc_rh, dec_rh))

    # phase A: tiled encode of the batch-concatenated pair; each scale's
    # crops written into whole pyramids
    img = torch.cat([img1, img2], dim=0)
    feats = None
    for i, (lo, hi, keep) in enumerate(_windows(h, n, s, enc_rh)):
        with tile_rows_ctx(lo, hi - lo, h):
            part = model.encoder(img[:, lo:hi].contiguous())
        if feats is None:
            feats = _map(lambda f, sh=hi - lo: f.new_empty(
                (f.shape[0], h // _scale(f, sh), *f.shape[2:])), part)
        for whole, f in zip(_leaves(feats), _leaves(part)):
            sc = _scale(f, hi - lo)
            whole[:, i * s // sc:(i + 1) * s // sc] = \
                f[:, keep // sc:(keep + s) // sc]
        del part

    # phase B: the model's fusion on the whole pyramids
    fused = model.fusion(feats, b)
    del feats

    # phase C: tiled decode on each slab's rows of the fused pyramids
    out = None
    for i, (lo, hi, keep) in enumerate(_windows(h, n, s, dec_rh)):
        def rows(t, lo=lo, hi=hi):
            sc = h // t.shape[1]
            return t[:, lo // sc:hi // sc].contiguous()
        with tile_rows_ctx(lo, hi - lo, h):
            y = model.decode_feats(_map(rows, fused))[:, keep:keep + s]
        if out is None:
            out = y.new_empty((y.shape[0], h, *y.shape[2:]))
        out[:, i * s:(i + 1) * s] = y
        del y
    return out
