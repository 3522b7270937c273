"""Work of the line-graph GNN (reference/lggnn.py), counted from the
molecules and the loader's bucket shapes. A molecule of n atoms, M = 2E
directed edges and K = nnz(AL) = sum over atoms of deg (deg - 1)
non-backtracking pairs costs, per layer (node state width w, edge state
width wl, h features, J powers; order 2):

- the node stack's J adjacency products, dense over its real atoms,
  2 J n^2 w; the edge stack's AL products in index form, 2 K wl each, for
  the 2^(J-1) applies the port makes;
- the exchange in index form (two nonzeros a column of Pm and Pd): Pm^T X
  and Pd^T X 2 (2M) w each, Pm ZL and Pd ZL 2 (2M) 2h each;
- the two Linear layers of each side, 2 * 2 n (node fan) h and
  2 * 2 M (edge fan) h;

and once a forward dL = AL 1, 2 K; the readout's node stack, Pm XL and
Pd XL as above and fc 2 n fan out. Batch norm, ReLU and the elementwise
blocks of the stacks are not counted. A step is the forward, x 3 for its
backward.

The batch norms' least time (``bounds["bn"]``): each of a step's
MaskedBatchNorm calls, over R = B x node bucket rows (node side) or
B x edge bucket rows (edge side) of F = 2h, reads its inputs and writes
its outputs once at those padded shapes (chip_smoke.py's count of the
BN kernels): forward h, mask, scale, bias, running mean and std in,
output, statistics (2F + 1) and the running buffers out; backward g, h,
mask, scale and statistics in, g_h, g_scale and g_bias out; over the
card's HBM (frozen.bound_s). B is the batch's own molecules: the cell's
pool deals into whole batches.
"""

from __future__ import annotations

import numpy as np

from benchmark import frozen

# hgnn2_torch/data/batching.py:DEFAULT_NODE_BUCKETS, DEFAULT_EDGE_BUCKETS
NODE_BUCKETS = (16, 32, 64, 128)
EDGE_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def bucket(n: int, buckets) -> int:
    """The smallest bucket that holds n (graphs.py:pad_to_bucket)."""
    return min(b for b in buckets if b >= n)


def receptive_field(mol) -> int:
    return mol.n_nodes


def _sizes(mol) -> tuple[int, int, int]:
    """Atoms, directed edges and non-backtracking pairs of a molecule."""
    a = np.asarray(mol.adj)
    deg = ((a != 0) & ~np.eye(a.shape[0], dtype=bool)).sum(1).astype(np.int64)
    return mol.n_nodes, int(deg.sum()), int((deg * (deg - 1)).sum())


def bn_bound_s(R: int, F: int) -> float:
    """The least seconds of one train-mode batch norm, forward and backward,
    over R rows of F features."""
    fwd = frozen.nbytes(((R, F), 4), ((R,), 4), ((F,), 4), ((F,), 4), ((F,), 4),
                        ((F,), 4), ((R, F), 4), ((2 * F + 1,), 4), ((F,), 4),
                        ((F,), 4))
    bwd = frozen.nbytes(((R, F), 4), ((R, F), 4), ((R,), 4), ((F,), 4),
                        ((2 * F + 1,), 4), ((R, F), 4), ((F,), 4), ((F,), 4))
    return frozen.bound_s(fwd, 0)[0] + frozen.bound_s(bwd, 0)[0]


def batch_work(cfg: dict, mols, k: int) -> dict:
    h, J, F = cfg["h"], cfg["J"], cfg["in_features"]
    n_layers = max(cfg["L"] - 1, 1)
    state = 2 * h
    nb_applies = 2 ** (J - 1)
    fwd = 0
    for mol in mols:
        n, M, K = _sizes(mol)
        fwd += 2 * K  # dL
        w, wl = F, 1
        for _ in range(n_layers):
            # the edge update (old node state), then the node update
            edge_fan = (J + 2) * wl + 2 * w
            node_fan = (J + 2) * w + 2 * state
            fwd += 2 * K * wl * nb_applies + 2 * 2 * (2 * M) * w
            fwd += 2 * 2 * M * edge_fan * h
            fwd += 2 * J * n * n * w + 2 * 2 * (2 * M) * state
            fwd += 2 * 2 * n * node_fan * h
            w = wl = state
        fwd += (2 * J * n * n * w + 2 * 2 * (2 * M) * wl
                + 2 * n * ((J + 2) * w + 2 * wl) * cfg["dim_output"])
    B = len(mols)
    n_b = bucket(max(m.n_nodes for m in mols), NODE_BUCKETS)
    m_b = bucket(max(_sizes(m)[1] for m in mols), EDGE_BUCKETS)
    bn = n_layers * (bn_bound_s(B * n_b, state) + bn_bound_s(B * m_b, state))
    return {"flops": 3 * fwd, "bounds": {"bn": bn}}
