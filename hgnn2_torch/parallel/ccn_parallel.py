"""Sharded CCN execution: the flattened vertex set split over ranks
(counterpart of hgnn2_tpu/parallel/ccn_parallel.py).

Molecules are dealt whole into shards (spmd.partition_records), so the
chi promotion gathers F[nbr] only inside a shard and no layer exchanges
anything; only the loss's sums cross ranks. A stacked CCNBatch carries a
leading rank axis. On the ranks of one device the shards run as one
batch (spmd.flatten_shards), so each layer is one set of launches for
every rank, the fused kernels K1-K4 included when the model has them on.

    shards = make_ccn_shards(records, grid.shape["edge"], k_max=..., ...)
    loss = sharded_ccn_loss(model, grid, "regression", mean, std)(shards)
"""

from __future__ import annotations

from typing import Sequence

import torch

from hgnn2_torch import resolve_device
from hgnn2_torch.graphs import GraphRecord
from hgnn2_torch.nn import ccn as ccn_mod
from hgnn2_torch.parallel import spmd


def make_ccn_shards(records: Sequence[GraphRecord], n_shards: int, k_max: int,
                    vertex_capacity: int, graphs_per_shard: int,
                    task: int | None = None, parts=None,
                    device: str | torch.device | None = None
                    ) -> ccn_mod.CCNBatch:
    """The molecules partitioned into n_shards balanced shards
    (partition_records, or ``parts``), each a CCNBatch of vertex_capacity
    vertices and graphs_per_shard graph slots, stacked on a leading rank
    axis; a shard with no molecule is all padding. Built on the host and
    moved to ``device`` (default cuda) once; every array equals the JAX
    package's."""
    dev = resolve_device(device)
    if parts is None:
        parts = spmd.partition_records(records, n_shards)
    feature_dim, y_dtype = spmd.padding_dims(records, task)
    batches = []
    for part in parts:
        if len(part) > graphs_per_shard:
            raise ValueError(f"shard holds {len(part)} graphs > "
                             f"graphs_per_shard={graphs_per_shard}")
        batches.append(ccn_mod.make_ccn_batch(
            part, k_max=k_max, vertex_capacity=vertex_capacity, task=task,
            batch_size=graphs_per_shard, feature_dim=feature_dim,
            y_dtype=y_dtype, device="cpu"))
    return spmd.stack_shards(batches, dev)


def make_sharded_ccn_apply(model, mesh: spmd.RankGrid | None = None):
    """apply(stacked) -> (S, B_shard, out): the model over (S, ...)
    stacked shards, each shard's graphs in its own row. The shards run as
    one flattened batch in the model's current mode. ``mesh``, when
    given, checks the stack against its "edge" axis (RankGrid.check)."""

    def apply(stacked):
        if mesh is not None:
            mesh.check(stacked, "edge")
        S, Gl = stacked.gmask.shape
        out = model(spmd.flatten_shards(stacked, 1))
        return out.reshape(S, Gl, -1)

    return apply


def sharded_ccn_loss(model, mesh: spmd.RankGrid | None = None,
                     kind: str = "regression", mean: float = 0.0,
                     std: float = 1.0):
    """loss_fn(stacked) -> the masked loss over every shard's graphs:
    each rank's sum of its real graphs' losses and its real-graph count,
    summed over the ranks (spmd.psum), then divided. Differentiable with
    respect to the model's parameters. ``mesh`` as in
    make_sharded_ccn_apply."""
    apply = make_sharded_ccn_apply(model, mesh)

    def loss_fn(stacked):
        out = apply(stacked)  # (S, B, out)
        S, Gl = stacked.gmask.shape
        per = spmd.per_graph_loss(out.reshape(S * Gl, -1),
                                  stacked.y.reshape(-1), kind, mean, std)
        num = spmd.psum((per.reshape(S, Gl) * stacked.gmask).sum(1), "edge", 1)
        den = spmd.psum(stacked.gmask.sum(1), "edge", 1)
        return num / den.clamp_min(1.0)

    return loss_fn
