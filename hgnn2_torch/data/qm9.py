"""QM9-shaped synthetic molecules (counterpart of hgnn2_tpu/data/qm9.py).

Only the synthetic generator and the chemical-accuracy table are ported
so far; xyz parsing and caches come with the data-ingestion slice. The numpy RNG calls are made in the same
order as the JAX package's generator, so one seed gives bit-equal records
in both packages.
"""

from __future__ import annotations

import numpy as np

from hgnn2_torch.graphs import GraphRecord

# chemical accuracy per QM9 task, in the task order of the targets
CHEMICAL_ACCURACY = np.array(
    [0.1, 0.05, 0.043, 0.043, 0.043, 0.043, 0.043, 0.1, 10.0, 1.2, 0.043,
     0.043, 0.0012],
    dtype=np.float32,
)

_ONE_HOT = {"H": 0, "C": 1, "N": 2, "O": 3}


def synthetic_qm9_like(n: int, seed: int = 0) -> list[GraphRecord]:
    """Random molecule-like graphs with QM9 statistics: 9-29 atoms, a
    random heavy-atom tree with extra ring closures (degree <= 4), hydrogen
    leaves, bond orders in {1, 1.5, 2, 3}, and targets that are smooth
    functions of graph structure (so models can actually fit them)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        n_heavy = int(rng.integers(2, 10))
        deg_cap = rng.choice([3, 4], size=n_heavy, p=[0.3, 0.7])
        adj_list = []
        for v in range(1, n_heavy):
            u = int(rng.integers(0, v))
            adj_list.append((u, v))
        # occasional ring closure
        if n_heavy >= 4 and rng.random() < 0.5:
            u, v = rng.choice(n_heavy, size=2, replace=False)
            if u != v and (min(u, v), max(u, v)) not in adj_list:
                adj_list.append((min(int(u), int(v)), max(int(u), int(v))))
        deg = np.zeros(n_heavy, dtype=np.int64)
        bonds = []
        for u, v in adj_list:
            if deg[u] < deg_cap[u] and deg[v] < deg_cap[v]:
                order = float(rng.choice([1.0, 1.5, 2.0, 3.0],
                                         p=[0.7, 0.1, 0.15, 0.05]))
                o = int(np.ceil(order))
                bonds.append((u, v, order))
                deg[u] += o
                deg[v] += o
        # hydrogens fill remaining valence
        symbols = list(rng.choice(["C", "C", "C", "N", "O"], size=n_heavy))
        atoms = n_heavy
        h_bonds = []
        for v in range(n_heavy):
            free = max(0, int(deg_cap[v]) - int(deg[v]))
            for _ in range(min(free, int(rng.integers(0, 4)))):
                h_bonds.append((v, atoms))
                symbols.append("H")
                atoms += 1
        na = atoms
        x = np.zeros((na, 5), dtype=np.float32)
        for i, s in enumerate(symbols):
            x[i, _ONE_HOT.get(s, 4)] = 1.0
        adj = np.zeros((na, na), dtype=np.float32)
        for u, v, order in bonds:
            adj[u, v] = adj[v, u] = order
        for u, v in h_bonds:
            adj[u, v] = adj[v, u] = 1.0
        # smooth structural targets + small noise
        base = np.array(
            [
                na,
                adj.sum() / 2.0,
                (adj == 2.0).sum() / 2.0,
                x[:, 1].sum(),
                x[:, 0].sum(),
            ],
            dtype=np.float32,
        )
        mix = rng_structural_mix()
        y = (mix @ base + 0.01 * rng.standard_normal(13)).astype(np.float32)
        out.append(GraphRecord(x=x, adj=adj, y=y))
    return out


_MIX_CACHE = {}


def rng_structural_mix() -> np.ndarray:
    """Fixed (13, 5) mixing matrix for synthetic targets."""
    if "m" not in _MIX_CACHE:
        _MIX_CACHE["m"] = np.random.default_rng(1234).standard_normal(
            (13, 5)).astype(np.float32)
    return _MIX_CACHE["m"]
