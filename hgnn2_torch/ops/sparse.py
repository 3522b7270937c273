"""Segment reductions over the flat vertex axis (counterpart of
hgnn2_tpu/ops/sparse.py). Only the per-graph readout is ported so far."""

from __future__ import annotations

import torch


def graph_readout(x: torch.Tensor, gid: torch.Tensor,
                  n_graphs: int) -> torch.Tensor:
    """Per-graph sum readout: (V, F) + (V,) -> (B, F); padding rows carry
    gid = n_graphs and land in an extra row that is dropped. On CUDA,
    index_add_ accumulates with atomics, so the sum order (and the last
    bits) can change from run to run."""
    out = x.new_zeros((n_graphs + 1, x.shape[1]))
    return out.index_add_(0, gid, x)[:n_graphs]
