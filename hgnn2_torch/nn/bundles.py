"""Operator bundles (counterpart of hgnn2_tpu/nn/bundles.py): what a model
applies to its features for one batch.

DenseBundle holds a DenseGraphBatch's adjacency powers, degrees and node
mask; the model builds it once per forward. Its line-graph side (edge
scatter matrices, the non-backtracking operator), FusedLGBundle and
MaterializedBundle come with the line-graph slice.
"""

from __future__ import annotations

import dataclasses

import torch

from hgnn2_torch.ops import dense as D


@dataclasses.dataclass
class DenseBundle:
    """Node-side operator bundle of a dense batch."""

    adj_powers: torch.Tensor  # (B, J, N, N)
    deg: torch.Tensor  # (B, N)
    J: int
    node_mask: torch.Tensor | None = None  # (B, N)

    @classmethod
    def from_batch(cls, batch, J: int,
                   dtype: torch.dtype | None = None) -> "DenseBundle":
        """dtype casts the operator tensors (bf16 compute); the powers
        and degrees are computed in f32 first, then cast."""
        adj_powers = D.adjacency_powers(batch.adj, J)
        deg = D.degrees(batch.adj)
        if dtype is not None:
            adj_powers, deg = adj_powers.to(dtype), deg.to(dtype)
        return cls(adj_powers=adj_powers, deg=deg, J=J,
                   node_mask=batch.node_mask)

    def graph_op(self, x: torch.Tensor) -> torch.Tensor:
        return D.graph_op(self.adj_powers, self.deg, x, self.node_mask)

    def _line_graph(self, *args):
        raise NotImplementedError(
            "line-graph operators come with the line-graph slice (B)")

    lg_graph_op = pm = pd = pm_t = pd_t = edge_features = _line_graph
