"""Dataset splitting (counterpart of hgnn2_tpu/data/synthetic.py). The
three-collinear-points generator comes with the classification slice."""

from __future__ import annotations

import numpy as np


def split_80_10_10(records: list, shuffle: bool = False, seed: int = 0):
    """The original 80/10/10 train/valid/test split, in record order
    unless shuffle (numpy's default_rng(seed), as in the JAX package)."""
    records = list(records)
    if shuffle:
        np.random.default_rng(seed).shuffle(records)
    n = len(records)
    n_train = int(0.8 * n)
    n_valid = int(0.1 * n)
    return (
        records[:n_train],
        records[n_train : n_train + n_valid],
        records[n_train + n_valid :],
    )
