"""Graph operators on the host with numpy (counterpart of
hgnn2_tpu/operators.py): the directed line graph of one graph, and the
dense operator builders that the tests use as oracles.

Conventions: directed edges come in (forward, reverse) pairs, e_{2k} =
(i -> j) and e_{2k+1} = (j -> i) for the k-th undirected edge (i < j),
scanning the upper triangle row-major, so M = 2E; self-loops are
excluded. rev[e] is the index of e's reverse edge. Pm[u, e] = Pm[v, e] =
1 for e = (u -> v); Pd[u, e] = +1, Pd[v, e] = -1. The non-backtracking
adjacency is AL[m1, m2] = w(m2) iff dst(m1) == src(m2) and src(m1) !=
dst(m2). The line graph comes from the C++ library (hgnn2_torch.native)
when it is available, else from the numpy path; both give the same
arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hgnn2_torch import native


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


def build_line_graph(A: np.ndarray, use_native: bool = True) -> LineGraph:
    """Directed line graph with interleaved forward/reverse edge pairs.

    Uses the C++ library (hgnn2_torch.native) when use_native and it is
    available; the numpy path below is the reference and the fallback."""
    if use_native and native.available():
        src, dst, w, rev = native.build_line_graph_native(A)
        return LineGraph(src=src, dst=dst, w=w, rev=rev)
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


def degrees(A: np.ndarray) -> np.ndarray:
    """Weighted degree vector d[i] = sum_j A[i, j]."""
    return np.asarray(A, dtype=np.float32).sum(axis=1)


def _power_stack(A: np.ndarray, J: int, diag: np.ndarray) -> np.ndarray:
    """(n, n, J+2) stack [I, diag(diag), A, A^2, A^4, ...] by repeated
    squaring (slot j + 2 holds A^(2^(j-1)))."""
    n = A.shape[0]
    out = np.zeros((n, n, J + 2), dtype=np.float32)
    out[:, :, 0] = np.eye(n, dtype=np.float32)
    out[:, :, 1] = np.diag(diag)
    out[:, :, 2] = A
    C = A.copy()
    for j in range(1, J):
        C = C @ C
        out[:, :, j + 2] = C
    return out


def operator_stack_dense(A: np.ndarray, J: int = 1) -> np.ndarray:
    """Dense (N, N, J+2) stack [I, diag(d), A, A^2, A^4, ...]."""
    A = np.asarray(A, dtype=np.float32)
    return _power_stack(A, J, degrees(A))


def nb_adjacency_dense(lg: LineGraph) -> np.ndarray:
    """Dense (M, M) non-backtracking adjacency: AL[m1, m2] = w(m2) iff
    dst(m1) == src(m2) and src(m1) != dst(m2)."""
    M = lg.num_edges
    cont = lg.dst[:, None] == lg.src[None, :]
    backtrack = lg.src[:, None] == lg.dst[None, :]
    AL = np.where(cont & ~backtrack, lg.w[None, :], 0.0)
    return AL.astype(np.float32).reshape(M, M)


def incidence_dense(lg: LineGraph, n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense incidence maps Pm, Pd of shape (N, M)."""
    M = lg.num_edges
    Pm = np.zeros((n_nodes, M), dtype=np.float32)
    Pd = np.zeros((n_nodes, M), dtype=np.float32)
    e = np.arange(M)
    Pm[lg.src, e] = 1.0
    Pm[lg.dst, e] = 1.0
    Pd[lg.src, e] = 1.0
    Pd[lg.dst, e] = -1.0
    return Pm, Pd


def line_graph_operator_stack_dense(A: np.ndarray, J: int = 1):
    """Dense line-graph operators of the intended semantics: (WL, Pm, Pd),
    WL (M, M, J+2) = [I, diag(dL), AL, AL^2, AL^4, ...], Pm/Pd (N, M),
    with M = 2E (every reverse edge present)."""
    A = np.asarray(A, dtype=np.float32)
    lg = build_line_graph(A)
    AL = nb_adjacency_dense(lg)
    Pm, Pd = incidence_dense(lg, A.shape[0])
    return _power_stack(AL, J, AL.sum(axis=1)), Pm, Pd


def line_graph_dense_compat(A: np.ndarray, J: int = 1):
    """The original implementation's line-graph builder, bug for bug:
    M = nnz(A) (both triangle halves), and the edge slot counter advances
    once per undirected edge, so each forward edge k >= 1 overwrites the
    reverse copy of edge k - 1 in the edge table while Pm/Pd keep the
    stale writes. Edge rows never written stay (0, 0, 0) and take part in
    the comparisons as such. For parity with that implementation only;
    line_graph_operator_stack_dense has the intended semantics."""
    A = np.asarray(A, dtype=np.float32)
    N = A.shape[0]
    M = int(np.count_nonzero(A))
    Pm = np.zeros((N, M), dtype=np.float32)
    Pd = np.zeros((N, M), dtype=np.float32)
    edges = np.zeros((M, 3), dtype=np.float32)
    e = 0
    for i in range(N):
        for j in range(i + 1, N):
            if A[i, j] != 0:
                Pm[i, e] = 1.0
                Pm[j, e] = 1.0
                Pd[i, e] = 1.0
                Pd[j, e] = -1.0
                edges[e] = (i, j, A[i, j])
                e += 1
                Pm[i, e] = 1.0
                Pm[j, e] = 1.0
                Pd[i, e] = -1.0
                Pd[j, e] = 1.0
                edges[e] = (j, i, A[i, j])
                # no second increment: the original's bug
    cont = edges[:, 1][:, None] == edges[:, 0][None, :]
    backtrack = edges[:, 0][:, None] == edges[:, 1][None, :]
    AL = np.where(cont & ~backtrack, edges[:, 2][None, :], 0.0).astype(np.float32)
    return _power_stack(AL, J, AL.sum(axis=1)), Pm, Pd
