"""Synthetic classification data and dataset splitting (counterpart of
hgnn2_tpu/data/synthetic.py).

three_collinear_points makes its numpy RNG calls in the JAX package's
order, so one seed gives bit-equal records in both packages. As there,
the adjacency's diagonal is zero (the original generator kept random
self-loops), so the line graph stays that of a simple graph.
"""

from __future__ import annotations

import numpy as np

from hgnn2_torch.graphs import GraphRecord


def three_collinear_points(
    n: int,
    n_max: int = 50,
    dim: int = 5,
    p: float = 0.5,
    c: float = 0.5,
    seed: int = 0,
) -> list[GraphRecord]:
    """n random graphs with an int label y in {0, 1}: with probability p
    the node features hold three collinear vectors (three random scalings
    of one random direction) at random positions, the task being to detect
    them. An edge exists with probability 1 - c; edge (0, 1) is forced."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ni = int(rng.integers(0, n_max - 3)) + 3
        y = int(rng.random() < p)
        if y:
            base = rng.standard_normal((1, dim)).astype(np.float32)
            three = 10.0 * rng.standard_normal((3, 1)).astype(np.float32) * base
            x = np.concatenate(
                [rng.standard_normal((ni - 3, dim)).astype(np.float32), three],
                axis=0)
            x = x[rng.permutation(ni)]
        else:
            x = rng.standard_normal((ni, dim)).astype(np.float32)
        a = (rng.random((ni, ni)) > c).astype(np.float32)
        a = np.triu(a, k=1)
        a[0, 1] = 1.0
        a = a + a.T
        out.append(GraphRecord(x=x, adj=a, y=np.int32(y)))
    return out


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
