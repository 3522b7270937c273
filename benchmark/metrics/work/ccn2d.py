"""Work of CCN-2D (reference/ccn2d.py), from the molecules' receptive
fields (each vertex and its neighbours, d_v <= K slots).

FLOPs: a layer of input width C costs a vertex C (2 d^3 + 22 d^2) for the
promotion's sums and the 18 contractions (chip_smoke.py's K3 count at
K = d) and 2 d^2 (18 C) h for its Linear; the readouts and fc are not
counted. A step is the forward, x 3 for its backward.

The promotion-contraction's least time (``bounds["ccn2d_contract"]``):
each layer's forward over the batch's real vertices V at the batch's K,
bytes = chi (V K K int32) + nbr (V K) + f (V K K C) + deg (V) + row mask
(V K) + out (V K K 18C), ops = V C (2 K^3 + 22 K^2); and the backward of
each layer after the first (the input needs no gradient), bytes = g
(V K K 18C) + deg + row mask + chi + rslot (V K) + nbr + df (V K K C), ops
= C (12 K S + (4 K + 12) P + 6 Q) with S the valid slots, P the valid
(u, j, p) and Q the valid (u, j, p, q) of the chi table (chip_smoke.py's
K4 count); each the larger of bytes over HBM and ops over the f32 peak
(frozen.bound_s).
"""

from __future__ import annotations

import numpy as np

from benchmark import frozen
from benchmark.reference import ccn2d as ref


def receptive_field(mol) -> int:
    return int(((np.asarray(mol.adj) > 0).sum(1) + 1).max())


def batch_work(cfg: dict, mols, k: int) -> dict:
    h, L, F = cfg["h"], cfg["L"], cfg["in_features"]
    t = ref.tables(mols)
    d = t["deg"].astype(np.float64)
    valid = t["chi"] >= 0
    V = len(d)
    S = float(d.sum())
    P = float(valid.sum())
    Q = float((valid.sum(2).astype(np.float64) ** 2).sum())
    fwd, bound = 0.0, 0.0
    widths = [F] + [h] * (L - 1)
    for i, C in enumerate(widths):
        fwd += C * (2 * d ** 3 + 22 * d ** 2).sum() + (2 * d ** 2 * 18 * C * h).sum()
        b3 = frozen.nbytes(((V, k, k), 4), ((V, k), 4), ((V, k, k, C), 4),
                           ((V,), 4), ((V, k), 4), ((V, k, k, 18 * C), 4))
        bound += frozen.bound_s(b3, V * C * (2 * k ** 3 + 22 * k ** 2))[0]
        if i > 0:
            b4 = frozen.nbytes(((V, k, k, 18 * C), 4), ((V,), 4), ((V, k), 4),
                               ((V, k, k), 4), ((V, k), 4), ((V, k), 4),
                               ((V, k, k, C), 4))
            ops = C * (12 * k * S + (4 * k + 12) * P + 6 * Q)
            bound += frozen.bound_s(b4, ops)[0]
    return {"flops": 3 * fwd, "bounds": {"ccn2d_contract": bound}}
