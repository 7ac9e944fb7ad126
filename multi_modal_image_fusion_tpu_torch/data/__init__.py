from .dataset import FusionDataset
from .io import imread_gray, imwrite
from .transform import denorm, norm

__all__ = ["FusionDataset", "denorm", "imread_gray", "imwrite", "norm"]
