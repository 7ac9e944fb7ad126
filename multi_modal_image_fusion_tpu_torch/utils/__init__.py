from .meters import AverageMeter
from .natsort import natsorted
from .split import train_test_split

__all__ = ["AverageMeter", "natsorted", "train_test_split"]
