"""Frozen copies of the port's sound pieces that the benchmark measures with,
so the yardstick does not move when the port changes. Each names the
source it was copied from, at commit 136d67e0d829 of this repository.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------- molecules


@dataclasses.dataclass
class Molecule:
    """One molecule as the benchmark makes it: node features (n, 5),
    weighted symmetric adjacency (n, n) and 13 targets."""

    x: np.ndarray
    adj: np.ndarray
    y: np.ndarray

    @property
    def n_nodes(self) -> int:
        return int(self.x.shape[0])


# hgnn2_torch/data/qm9.py:_ONE_HOT
_ONE_HOT = {"H": 0, "C": 1, "N": 2, "O": 3}


def _structural_mix() -> np.ndarray:
    """hgnn2_torch/data/qm9.py:rng_structural_mix: the fixed (13, 5) mixing
    matrix of the synthetic targets."""
    return np.random.default_rng(1234).standard_normal((13, 5)).astype(
        np.float32)


def synthetic_qm9_like(n: int, seed: int) -> list[Molecule]:
    """hgnn2_torch/data/qm9.py:synthetic_qm9_like: random molecule-like
    graphs with QM9's statistics (2-26 atoms here, a heavy-atom tree with
    ring closures, degree <= 4, hydrogen leaves, bond orders in
    {1, 1.5, 2, 3}, targets smooth in the structure). The same seed gives
    the same molecules, draw for draw as the source's."""
    rng = np.random.default_rng(seed)
    mix = _structural_mix()
    out = []
    for _ in range(n):
        n_heavy = int(rng.integers(2, 10))
        deg_cap = rng.choice([3, 4], size=n_heavy, p=[0.3, 0.7])
        adj_list = []
        for v in range(1, n_heavy):
            u = int(rng.integers(0, v))
            adj_list.append((u, v))
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
        base = np.array([na, adj.sum() / 2.0, (adj == 2.0).sum() / 2.0,
                         x[:, 1].sum(), x[:, 0].sum()], dtype=np.float32)
        y = (mix @ base + 0.01 * rng.standard_normal(13)).astype(np.float32)
        out.append(Molecule(x=x, adj=adj, y=y))
    return out


# ------------------------------------------------------------------ serving

# hgnn2_torch/scripts/bench_serving.py:BUCKETS: the serving buckets' graph
# slots, primary first (256), then the small tail (16) and big requests
# (2,048). A CCN bucket's vertex capacity is its first records' atoms + 8.
SERVE_BUCKETS = (256, 16, 2048)
CCN_CAPACITY_SLACK = 8

# ------------------------------------------------------------------ peaks

# hgnn2_torch/profiling.py:_CARD_PEAK_FLOPS and _CARD_PEAK_HBM: NVIDIA H100
# Tensor Core GPU data sheet, SXM part, dense rates, at its 700 W limit.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """chip_smoke.py:_bound: the least time for n_bytes over the card's HBM
    and n_ops float32 operations outside the tensor cores, at the
    data-sheet peaks, in seconds, and which of the two bounds it."""
    t_bytes = n_bytes / PEAK_HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*shapes_dtypes) -> int:
    """chip_smoke.py:_nbytes over (shape, bytes per element) pairs: each
    tensor read or written once."""
    return int(sum(int(np.prod(shape)) * size for shape, size in shapes_dtypes))


# ------------------------------------------------------------------ profiles


def category(name: str) -> str:
    """hgnn2_torch/scripts/profile_ccn1d_util.py:_category: kineto names a
    copy "Memcpy HtoD (...)" and a fill "Memset (...)"; every other device
    event is a kernel."""
    for prefix in ("Memcpy", "Memset"):
        if name.startswith(prefix):
            return prefix.lower()
    return "kernel"


def parse_kernel_stats(prof) -> list[dict]:
    """hgnn2_torch/scripts/profile_ccn1d_util.py:parse_kernel_stats: the
    device events of a finished torch.profiler.profile (the kernels of
    replayed CUDA graphs included), one row a name, largest self device
    time first: category, op_name, occurrences, total_time (us)."""
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        rows.append({"category": category(e.key), "op_name": e.key,
                     "occurrences": e.count,
                     "total_time": float(e.self_device_time_total)})
    rows.sort(key=lambda r: -r["total_time"])
    return rows
