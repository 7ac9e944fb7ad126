"""Natural-order sorting (replacement for the `natsort` dependency).

The reference lists image files with ``natsorted(os.listdir(dir))``
(reference data/dataset.py:97, data/patches.py:88, eval.py:181); file pairing
and the train/valid split depend on this ordering, so we reproduce it: split
each string into digit and non-digit runs and compare digit runs numerically.
"""

import re

_SPLIT = re.compile(r"(\d+)")


def natsort_key(s):
    parts = _SPLIT.split(str(s))
    # Numeric runs sort as (0, int, ""), text runs as (1, 0, text): natsort's
    # default puts numbers before text when compared at the same position.
    key = []
    for p in parts:
        if p.isdigit():
            key.append((0, int(p), ""))
        elif p:
            key.append((1, 0, p))
    return key


def natsorted(seq):
    return sorted(seq, key=natsort_key)
