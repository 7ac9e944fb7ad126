from .dataset import AEDataset, FusionDataset, FusionPatches
from .io import imread_gray, imwrite
from .patches import extract_patches, patchify
from .pipeline import Feeder
from .transform import denorm, norm, transform

__all__ = ["AEDataset", "Feeder", "FusionDataset", "FusionPatches",
           "denorm", "extract_patches", "imread_gray", "imwrite", "norm",
           "patchify", "transform"]
