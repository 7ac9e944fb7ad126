"""File + console logger (the port's copy of multi_modal_image_fusion_tpu
utils/logger.py; reference common.py:169-210): <ckpt_dir>/train.log."""

import logging
import os


class Logger:
    def __init__(self, log_path):
        log_dir = os.path.dirname(log_path)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self.log_path = log_path

    def init_logger(self):
        # keyed by full path: several runs in one process (tests, sweeps)
        # must not share file handlers
        logger = logging.getLogger(os.path.abspath(self.log_path))
        logger.setLevel(logging.INFO)
        if logger.handlers:          # idempotent across repeated init
            return logger
        fmt = logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s")

        file_handler = logging.FileHandler(self.log_path, "w")
        file_handler.setLevel(logging.INFO)
        file_handler.setFormatter(fmt)

        console_handler = logging.StreamHandler()
        console_handler.setLevel(logging.INFO)

        logger.addHandler(file_handler)
        logger.addHandler(console_handler)
        return logger


def close_logger(logger):
    """Close and detach the logger's handlers (the file stays complete)."""
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)
