"""Graph containers (counterpart of hgnn2_tpu/graphs.py): the host-side
record, with its memoized max degree and line graph, and the packed batch
of the segment-sum models.

PackedGraphBatch is assembled with numpy on the host and copied to the
device once; its arrays equal the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from hgnn2_torch import operators, resolve_device


@dataclasses.dataclass
class GraphRecord:
    """One graph on the host: features, adjacency and targets (numpy)."""

    x: np.ndarray  # (N, F) node features
    adj: np.ndarray  # (N, N) weighted symmetric adjacency
    y: np.ndarray  # (T,) regression targets or () int label
    _max_degree: int | None = None  # memoized (CCN receptive-field scan)
    lg: operators.LineGraph | None = None  # built lazily

    @property
    def n_nodes(self) -> int:
        return int(self.x.shape[0])

    def max_degree(self) -> int:
        """Largest unweighted degree (no self-loop), memoized."""
        if self._max_degree is None:
            self._max_degree = int((np.asarray(self.adj) > 0).sum(1).max())
        return self._max_degree

    def line_graph(self) -> operators.LineGraph:
        if self.lg is None:
            self.lg = operators.build_line_graph(self.adj)
        return self.lg

    @property
    def n_dir_edges(self) -> int:
        return self.line_graph().num_edges


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; raises if none fits."""
    for b in sorted(buckets):
        if b >= n:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {max(buckets)}")


@dataclasses.dataclass
class PackedGraphBatch:
    """Flat packed layout with segment ids.

    x:         (V, F) float32 node features, V = static node capacity
    node_gid:  (V,) int32 graph id per node; padding rows hold B (one past
               the last real graph) so readouts drop them
    node_mask: (V,) float32 1.0 for real nodes
    src, dst:  (C,) int32 directed-edge endpoints as global node indices,
               C = static edge capacity; padded edges point at V-1
    w:         (C,) float32 edge weight (0 at padding)
    rev:       (C,) int32 global reverse-edge index (padding: itself)
    edge_gid:  (C,) int32 graph id per edge (B at padding)
    edge_mask: (C,) float32
    y:         (B,) targets
    gmask:     (B,) float32 1.0 for real graphs (0 for batch-size padding)
    n_graphs:  B, a plain int
    """

    x: torch.Tensor
    node_gid: torch.Tensor
    node_mask: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    rev: torch.Tensor
    edge_gid: torch.Tensor
    edge_mask: torch.Tensor
    y: torch.Tensor
    gmask: torch.Tensor
    n_graphs: int = 0

    @property
    def num_node_slots(self) -> int:
        return self.x.shape[0]

    @property
    def num_edge_slots(self) -> int:
        return self.src.shape[0]

    def to(self, device) -> "PackedGraphBatch":
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)}
        return PackedGraphBatch(**{
            k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in fields.items()})


def make_packed_batch(
    records: Sequence[GraphRecord],
    node_capacity: int | None = None,
    edge_capacity: int | None = None,
    task: int | None = None,
    batch_size: int | None = None,
    feature_dim: int | None = None,
    y_dtype=None,
    device: str | torch.device | None = None,
) -> PackedGraphBatch:
    """Packs many graphs into flat arrays with static capacities, on the
    host, and copies them to ``device`` (default cuda) once.

    batch_size pads the graph axis with empty graphs (gmask 0). An empty
    record list builds an all-padding batch; feature_dim and y_dtype must
    then be given."""
    dev = resolve_device(device)
    bs = len(records)
    B = batch_size or bs
    if bs > B:
        raise ValueError(f"{bs} records exceed batch_size {B}")
    tot_n = sum(r.n_nodes for r in records)
    lgs = [r.line_graph() for r in records]
    tot_m = sum(lg.num_edges for lg in lgs)
    V = node_capacity or tot_n
    C = edge_capacity or tot_m
    if tot_n > V:
        raise ValueError(f"node capacity too small: {tot_n} nodes > capacity {V}")
    if tot_m > C:
        raise ValueError(f"edge capacity too small: {tot_m} edges > capacity {C}")
    if records:
        F = records[0].x.shape[1]
    elif feature_dim is not None:
        F = feature_dim
    else:
        raise ValueError("feature_dim is required for an empty record list")
    if V < 1 or C < 1:
        raise ValueError("capacities must be >= 1 (padding needs one slot)")

    x = np.zeros((V, F), dtype=np.float32)
    node_gid = np.full((V,), B, dtype=np.int32)
    node_mask = np.zeros((V,), dtype=np.float32)
    src = np.full((C,), V - 1, dtype=np.int32)
    dst = np.full((C,), V - 1, dtype=np.int32)
    w = np.zeros((C,), dtype=np.float32)
    rev = np.arange(C, dtype=np.int32)
    edge_gid = np.full((C,), B, dtype=np.int32)
    edge_mask = np.zeros((C,), dtype=np.float32)

    n_off = e_off = 0
    ys = []
    for g, (r, lg) in enumerate(zip(records, lgs)):
        n, m = r.n_nodes, lg.num_edges
        x[n_off : n_off + n] = r.x
        node_gid[n_off : n_off + n] = g
        node_mask[n_off : n_off + n] = 1.0
        src[e_off : e_off + m] = lg.src + n_off
        dst[e_off : e_off + m] = lg.dst + n_off
        w[e_off : e_off + m] = lg.w
        rev[e_off : e_off + m] = lg.rev + e_off
        edge_gid[e_off : e_off + m] = g
        edge_mask[e_off : e_off + m] = 1.0
        n_off += n
        e_off += m
        ys.append(r.y if task is None else r.y[task])
    if ys:
        y = np.stack([np.asarray(t) for t in ys], axis=0)
        if not np.issubdtype(y.dtype, np.integer):
            y = y.astype(np.float32)
        if B > bs:
            y = np.concatenate([y, np.zeros((B - bs,) + y.shape[1:], y.dtype)])
    else:
        y = np.zeros((B,), y_dtype or np.float32)
    gmask = np.zeros((B,), np.float32)
    gmask[:bs] = 1.0
    arrays = dict(x=x, node_gid=node_gid, node_mask=node_mask, src=src,
                  dst=dst, w=w, rev=rev, edge_gid=edge_gid,
                  edge_mask=edge_mask, y=y, gmask=gmask)
    return PackedGraphBatch(
        **{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()},
        n_graphs=B)
