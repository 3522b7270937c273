"""Operator bundles (counterpart of hgnn2_tpu/nn/bundles.py): what a model
applies to its features for one batch.

  * DenseBundle: the production path. It holds a DenseGraphBatch's
    adjacency powers, degrees and node mask and, for the line-graph GNN,
    the edge arrays and NB degrees. The power operators are a batched
    matmul (ops/dense.py). The line-graph exchange is one path, the index
    form of ops/lg_exchange.py (gathers and segment sums over src, dst and
    rev), on every device and in every dtype: its wrappers launch the
    CUDA kernels in float32 on the card and run their plain versions
    elsewhere. The model builds it once per forward.
  * MaterializedBundle: explicit dense operator stacks and incidence
    matrices (the original implementation's layout, hgnn2_torch.operators'
    dense builders); the oracle of the production path in the tests.
"""

from __future__ import annotations

import dataclasses

import torch

from hgnn2_torch import profiling
from hgnn2_torch.ops import dense as D
from hgnn2_torch.ops import lg_exchange as X

EXCHANGE = "hgnn2.lg.exchange"


@dataclasses.dataclass
class DenseBundle:
    """Operator bundle computed from a dense batch's adjacency and edge
    arrays; the line-graph exchange runs in index form over the batch's
    int32 src, dst and rev."""

    adj_powers: torch.Tensor  # (B, J, N, N)
    deg: torch.Tensor  # (B, N)
    J: int
    node_mask: torch.Tensor | None = None  # (B, N)
    # line-graph pieces (None for power-GNN batches)
    src: torch.Tensor | None = None  # (B, M) int32
    dst: torch.Tensor | None = None
    rev: torch.Tensor | None = None
    w: torch.Tensor | None = None  # (B, M), the compute dtype
    dl: torch.Tensor | None = None  # (B, M) NB degrees
    edge_mask: torch.Tensor | None = None

    @classmethod
    def from_batch(cls, batch, J: int, with_line_graph: bool = False,
                   dtype: torch.dtype | None = None) -> "DenseBundle":
        """dtype casts the operator tensors (bf16 compute); the powers,
        degrees and NB degrees are computed in f32 first, then cast. The
        line graph keeps the batch's int32 src, dst and rev, and dl is one
        NB apply (lg_exchange.nb_degrees), in the host span
        hgnn2.lg.bundle."""
        adj_powers = D.adjacency_powers(batch.adj, J)
        deg = D.degrees(batch.adj)
        if dtype is not None:
            adj_powers, deg = adj_powers.to(dtype), deg.to(dtype)
        if not (with_line_graph and batch.has_line_graph):
            return cls(adj_powers=adj_powers, deg=deg, J=J,
                       node_mask=batch.node_mask)
        with profiling.span("hgnn2.lg.bundle"):
            src, dst, rev = batch.lg_src, batch.lg_dst, batch.lg_rev
            w, emask = batch.lg_w, batch.edge_mask
            dl = X.nb_degrees(src, dst, rev, emask, w, batch.x.shape[1])
            if dtype is not None:
                w, emask, dl = w.to(dtype), emask.to(dtype), dl.to(dtype)
        return cls(adj_powers=adj_powers, deg=deg, J=J,
                   node_mask=batch.node_mask, src=src, dst=dst, rev=rev, w=w,
                   dl=dl, edge_mask=emask)

    @property
    def has_line_graph(self) -> bool:
        return self.w is not None

    def graph_op(self, x: torch.Tensor) -> torch.Tensor:
        return D.graph_op(self.adj_powers, self.deg, x, self.node_mask)

    # the line-graph exchange, each apply in the host span hgnn2.lg.exchange

    def lg_graph_op(self, xl: torch.Tensor) -> torch.Tensor:
        with profiling.span(EXCHANGE):
            return X.lg_graph_op(self.src, self.dst, self.rev, self.edge_mask,
                                 self.w, self.dl, xl, self.J,
                                 self.deg.shape[1])

    def pm_pd(self, xl: torch.Tensor) -> torch.Tensor:
        """[Pm xl | Pd xl]: (B, M, F) -> (B, N, 2F)."""
        with profiling.span(EXCHANGE):
            return X.pm_pd(self.src, self.dst, self.edge_mask, xl,
                           self.deg.shape[1])

    def pm_pd_t(self, x: torch.Tensor) -> torch.Tensor:
        """[Pm^T x | Pd^T x]: (B, N, F) -> (B, M, 2F)."""
        with profiling.span(EXCHANGE):
            return X.pm_pd_t(self.src, self.dst, self.edge_mask, x)

    def edge_features(self) -> torch.Tensor:
        """Initial edge state XL = the NB line-graph degrees, (B, M, 1)."""
        return self.dl[:, :, None]


@dataclasses.dataclass
class MaterializedBundle:
    """Bundle over explicit dense operator tensors."""

    W: torch.Tensor  # (B, N, N, J+2)
    WL: torch.Tensor | None = None  # (B, M, M, J+2)
    Pm: torch.Tensor | None = None  # (B, N, M)
    Pd: torch.Tensor | None = None

    @property
    def has_line_graph(self) -> bool:
        return self.WL is not None

    def graph_op(self, x: torch.Tensor) -> torch.Tensor:
        return D.graph_op_materialized(self.W, x)

    def lg_graph_op(self, xl: torch.Tensor) -> torch.Tensor:
        return D.graph_op_materialized(self.WL, xl)

    def pm_pd(self, xl: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.einsum("bnm,bmf->bnf", self.Pm, xl),
                          torch.einsum("bnm,bmf->bnf", self.Pd, xl)], dim=-1)

    def pm_pd_t(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.einsum("bnm,bnf->bmf", self.Pm, x),
                          torch.einsum("bnm,bnf->bmf", self.Pd, x)], dim=-1)

    def edge_features(self) -> torch.Tensor:
        dl = torch.diagonal(self.WL[:, :, :, 1], dim1=1, dim2=2)
        return dl[:, :, None]
