"""The line-graph GNN through the port: hgnn2_torch.nn.models.GNNLineGraph
(update order 2, no fused operators, as the CLI builds it) over dense
batches with their directed line graphs (data.batching.DenseLoader with
with_line_graph, sorted by atoms).

The records reach the loader sorted by atoms, and among equal atoms by
directed edges, most first, each sort stable: the loader's sort by atoms
keeps that order, so every seed deals the same batch shapes, 13 batches
at node/edge buckets 16/32 and 3 at 32/64. Sorted by atoms alone, the
batch where 16 atoms give way to 17 took its edge bucket from the seed's
order among the 17-atom molecules (32 or 64 directed edges: 2 or 3 shape
groups, and another peak memory); with most edges first it takes the
17-atom molecules with ring closures, so 64. Within one size and edge
count the seed's order stays."""

from __future__ import annotations

import numpy as np

from hgnn2_torch.data import batching
from hgnn2_torch.nn import models


def build(cfg: dict, device, k_max=None):
    return models.GNNLineGraph(in_features=cfg["in_features"], n_features=cfg["h"],
                               n_layers=cfg["L"], dim_output=cfg["dim_output"],
                               J=cfg["J"], order=cfg["order"]).to(device)


def by_size(mols) -> np.ndarray:
    """Indices of molecules (or records) sorted by atoms, ascending, then by
    directed edges (the nonzeros of A off its diagonal), descending, each
    sort stable."""
    edges = np.array([np.count_nonzero(m.adj) - np.count_nonzero(np.diagonal(m.adj))
                      for m in mols])
    atoms = np.array([m.n_nodes for m in mols])
    order = np.argsort(-edges, kind="stable")
    return order[np.argsort(atoms[order], kind="stable")]


def train_loader(records, batch: int, cfg: dict, device):
    return batching.DenseLoader([records[i] for i in by_size(records)], batch,
                                task=cfg["task"], with_line_graph=True, sort=True,
                                device=device)


def deal(mols, batch: int) -> list[np.ndarray]:
    """The molecules of each batch in the loader's deal order."""
    order = by_size(mols)
    return [order[s:s + batch] for s in range(0, len(order), batch)]
