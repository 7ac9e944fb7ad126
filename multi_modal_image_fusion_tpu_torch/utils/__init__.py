from .logger import Logger
from .meters import AverageMeter
from .natsort import natsorted
from .seed import setup_seed
from .split import train_test_split

__all__ = ["AverageMeter", "Logger", "natsorted", "setup_seed",
           "train_test_split"]
