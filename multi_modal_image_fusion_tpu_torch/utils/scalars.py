"""Scalar logging (the port's copy of multi_modal_image_fusion_tpu
utils/scalars.py): JSONL always (<ckpt_dir>/scalars.jsonl), plus TensorBoard
event files from the dependency-free writer in utils/tbevents.py, covering
the reference's SummaryWriter usage (train.py:167, 100-110, 355-356)."""

import json
import os
import time

from .tbevents import TFEventWriter


class ScalarWriter:
    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = TFEventWriter(log_dir)

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({
            "tag": tag, "value": float(value), "step": int(step),
            "time": time.time()
        }) + "\n")
        self._tb.add_scalar(tag, float(value), int(step))

    def flush(self):
        self._f.flush()
        self._tb.flush()

    def close(self):
        self._f.close()
        self._tb.close()
