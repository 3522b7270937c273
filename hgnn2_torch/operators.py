"""Directed line graph of one graph, on the host with numpy (counterpart of
hgnn2_tpu/operators.py: LineGraph, undirected_edges, build_line_graph).

Conventions: directed edges come in (forward, reverse) pairs, e_{2k} =
(i -> j) and e_{2k+1} = (j -> i) for the k-th undirected edge (i < j),
scanning the upper triangle row-major, so M = 2E; self-loops are
excluded. rev[e] is the index of e's reverse edge. Only the numpy path
is ported; it gives the same arrays as the JAX package's C++ library.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LineGraph:
    """Directed line-graph (edge-dual) structure of one graph.

    src: (M,) int32 source node of each directed edge
    dst: (M,) int32 destination node
    w:   (M,) float32 edge weight (bond order for QM9)
    rev: (M,) int32 index of the reverse edge (rev[2k] = 2k+1)
    """

    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    rev: np.ndarray

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def undirected_edges(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangular (i < j) edge list of a symmetric adjacency:
    edges (E, 2) int32 row-major over the upper triangle and weights (E,)
    float32 = A[i, j]. Self-loops excluded."""
    A = np.asarray(A)
    iu, ju = np.triu_indices(A.shape[0], k=1)
    keep = A[iu, ju] != 0
    edges = np.stack([iu[keep], ju[keep]], axis=1).astype(np.int32)
    return edges, A[iu[keep], ju[keep]].astype(np.float32)


def build_line_graph(A: np.ndarray) -> LineGraph:
    """Directed line graph with interleaved forward/reverse edge pairs."""
    edges, w = undirected_edges(A)
    E = edges.shape[0]
    src = np.empty(2 * E, dtype=np.int32)
    dst = np.empty(2 * E, dtype=np.int32)
    ww = np.empty(2 * E, dtype=np.float32)
    src[0::2], dst[0::2] = edges[:, 0], edges[:, 1]
    src[1::2], dst[1::2] = edges[:, 1], edges[:, 0]
    ww[0::2] = w
    ww[1::2] = w
    rev = np.arange(2 * E, dtype=np.int32)
    rev[0::2] += 1
    rev[1::2] -= 1
    return LineGraph(src=src, dst=dst, w=ww, rev=rev)
