"""Reproducibility (the port's counterpart of multi_modal_image_fusion_tpu
utils/seed.py; reference common.py:84-93): seeds python's `random` (dataset
shuffles), numpy's global RNG (host-side draws) and torch's generators."""

import random

import numpy as np
import torch


def setup_seed(seed=0):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
