"""Work of the power GNN (reference/gnn.py). A molecule of n atoms costs,
per layer of input width w, the operator stack's J adjacency products
2 J n^2 w (dense over its real atoms) and the two Linear layers
2 * 2 n (J + 2) w h; the readout 2 n (J + 2) w out; J > 1 adds the powers'
squarings, 2 n^3 each. Batch norm, ReLU and the elementwise blocks of the
stack are not counted. A step is the forward, x 3 for its backward."""

from __future__ import annotations


def receptive_field(mol) -> int:
    return mol.n_nodes


def batch_work(cfg: dict, mols, k: int) -> dict:
    h, J, L = cfg["h"], cfg["J"], cfg["L"]
    widths = [cfg["in_features"]] + [2 * h] * (L - 1)
    fwd = 0
    for m in mols:
        n = m.n_nodes
        fwd += 2 * n ** 3 * (J - 1)
        for i in range(L - 1):
            w = widths[i]
            fwd += 2 * J * n * n * w + 2 * 2 * n * (J + 2) * w * h
        fwd += 2 * J * n * n * widths[-1] + 2 * n * (J + 2) * widths[-1] * cfg["dim_output"]
    return {"flops": 3 * fwd, "bounds": {}}
