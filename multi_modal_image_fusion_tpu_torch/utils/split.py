"""Deterministic train/valid split, bit-compatible with
``sklearn.model_selection.train_test_split(..., test_size=0.2, random_state=0)``
as used by the reference (data/dataset.py:111-114, data/patches.py:98-102),
but implemented with numpy only.

sklearn draws ``permutation = RandomState(seed).permutation(n)`` and takes the
first ``ceil(n * test_size)`` indices as the test set and the next
``n - n_test`` as the train set. We reproduce that exactly so the 80/20
train/valid membership matches the reference run-for-run.
"""

import math

import numpy as np


def split_indices(n, test_size=0.2, random_state=0):
    n_test = int(math.ceil(n * test_size))
    n_train = n - n_test
    perm = np.random.RandomState(random_state).permutation(n)
    test_idx = perm[:n_test]
    train_idx = perm[n_test:n_test + n_train]
    return train_idx, test_idx


def train_test_split(*arrays, test_size=0.2, random_state=0):
    """Returns [a_train, a_test, b_train, b_test, ...] like sklearn."""
    n = len(arrays[0])
    train_idx, test_idx = split_indices(n, test_size, random_state)
    out = []
    for arr in arrays:
        out.append([arr[i] for i in train_idx])
        out.append([arr[i] for i in test_idx])
    return out
