"""The eligibility rules and the receptive halo of height sharding
(counterpart of multi_modal_image_fusion_tpu parallel/spatial.py:48-106),
which single-card height tiling (parallel/tiling.py) shares.

Spatial sharding itself (one pair's height over several cards:
`spatial_forward`, `spatial_forward_multiscale`, the spatial train step)
is not ported yet: ROADMAP.md queue 1 item 7b.
"""

__all__ = ["SPATIAL_ELIGIBLE", "check_spatial_eligible", "receptive_halo"]

# Models whose forward is a stride-1 conv stack with per-pixel-local
# fusion; keys match models.create_model
SPATIAL_ELIGIBLE = ("deepfuse", "densefuse", "vifnet", "pfnetv1",
                    "pfnetv2", "ifcnn", "difnet", "pmgi")

# Fusion modes that reduce over the full spatial extent (reference
# fusion.py:97-150); a model configured with one cannot be split by height
# exactly
_GLOBAL_FUSION_MODES = ("nl", "nuclear")


def receptive_halo(model):
    """Upper bound on the forward's receptive-field halo, in rows: the sum
    of k // 2 over every 4-D conv weight among the model's parameters
    (OIHW, or IOHW for a transpose conv: k is dim 2; the JAX package reads
    dim 0 of its HWIO kernels). Exact for a sequential stride-1 stack, an
    over-estimate where blocks branch, which costs overlap compute but
    keeps the result exact. Only `named_parameters()` count, never weights
    derived from them (PFNetv2.fuse_weights, ConvLayer.folded)."""
    return sum(int(p.shape[2]) // 2 for _, p in model.named_parameters()
               if p.dim() == 4)


def check_spatial_eligible(model_name, fusion_mode=None):
    name = model_name.lower()
    if name not in SPATIAL_ELIGIBLE:
        raise ValueError(
            f"model '{model_name}' cannot be height-sharded exactly: "
            f"only stride-1 local-fusion models qualify "
            f"({', '.join(SPATIAL_ELIGIBLE)}); multi-scale transitions "
            f"and global fusion change the halo geometry")
    if fusion_mode in _GLOBAL_FUSION_MODES:
        raise ValueError(
            f"fusion mode '{fusion_mode}' reduces over the full image "
            f"and cannot be height-sharded exactly")
