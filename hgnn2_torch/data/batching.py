"""Static bucketed batching for the dense power and line-graph GNNs, the
packed GNNs and the CCN models (counterpart of
hgnn2_tpu/data/batching.py).

Every batch is padded to a node (and, with line graphs, a directed-edge)
bucket, to packed node and edge capacities or to a vertex-capacity
bucket, and to a fixed graph count, so the number of distinct batch
shapes stays small;
graph-count padding appends empty graphs that the loss ignores. Batches
are built on the host with numpy and moved to the loader's device once.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from hgnn2_torch import graphs
from hgnn2_torch.graphs import GraphRecord, pad_to_bucket
from hgnn2_torch.nn import ccn as ccn_mod

DEFAULT_NODE_BUCKETS = (16, 32, 64, 128)
DEFAULT_EDGE_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


@dataclasses.dataclass
class DenseLoader:
    """Yields DenseGraphBatch objects padded to a node bucket and to
    batch_size graphs, on ``device`` (default cuda).

    shuffle permutes the records with numpy's default_rng(seed + epoch)
    each epoch; sort=True then orders them by node count (a stable sort,
    so equal sizes keep the shuffled order), which groups graphs of
    similar size into the same batches. with_line_graph adds the directed
    line graphs, padded to the edge bucket of the batch's most edges."""

    records: Sequence[GraphRecord]
    batch_size: int
    task: int | None = None
    with_line_graph: bool = False
    node_buckets: Sequence[int] = DEFAULT_NODE_BUCKETS
    edge_buckets: Sequence[int] = DEFAULT_EDGE_BUCKETS
    sort: bool = True
    shuffle: bool = False
    seed: int = 0
    device: str | torch.device | None = None
    _epoch: int = 0

    def __iter__(self) -> Iterator[graphs.DenseGraphBatch]:
        idx = np.arange(len(self.records))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
            self._epoch += 1
        if self.sort:
            sizes = np.array([self.records[i].n_nodes for i in idx])
            idx = idx[np.argsort(sizes, kind="stable")]
        for s in range(0, len(idx), self.batch_size):
            chunk = [self.records[i] for i in idx[s : s + self.batch_size]]
            n_bucket = pad_to_bucket(max(r.n_nodes for r in chunk),
                                     self.node_buckets)
            m_bucket = (pad_to_bucket(max(r.n_dir_edges for r in chunk),
                                      self.edge_buckets)
                        if self.with_line_graph else None)
            yield graphs.make_dense_batch(
                chunk, n_max=n_bucket, m_max=m_bucket,
                with_line_graph=self.with_line_graph,
                batch_size=self.batch_size, task=self.task,
                device=self.device)

    def __len__(self) -> int:
        return (len(self.records) + self.batch_size - 1) // self.batch_size


@dataclasses.dataclass
class CachedLoader:
    """Builds every batch of an inner loader once and replays the (already
    device-resident) batches on later epochs, reshuffling batch ORDER only
    (numpy's default_rng(seed + epoch)).

    Batch composition is fixed for the run unless redeal_every=K, which
    rebuilds the batches from the inner loader every K iterations; give the
    inner loader shuffle=True so each rebuild is a fresh deal."""

    inner: object
    shuffle: bool = True
    seed: int = 0
    redeal_every: int = 0
    _batches: list | None = None
    _epoch: int = 0
    _iters: int = 0

    def materialize(self) -> "CachedLoader":
        if self._batches is None:
            self._batches = list(self.inner)
        return self

    def peek_sample(self):
        """First cached batch WITHOUT starting an iteration (__iter__
        advances the re-deal clock)."""
        self.materialize()
        return self._batches[0]

    def batches(self) -> list:
        """The materialized batch list (built if needed), in deal order."""
        self.materialize()
        return self._batches

    def release(self) -> None:
        """Drop the cached batches; the next materialize rebuilds them."""
        self._batches = None

    def maybe_redeal(self) -> bool:
        """Advance the iteration counter; drop the cache when a re-deal is
        due (every redeal_every-th iteration). Returns True when the next
        materialize() will rebuild. __iter__ calls it; the grouped epoch
        order of training.train.fit calls it once per epoch instead."""
        due = bool(
            self.redeal_every
            and self._iters
            and self._iters % self.redeal_every == 0
        )
        self._iters += 1
        if due:
            self._batches = None
        return due

    def __iter__(self):
        self.maybe_redeal()
        self.materialize()
        order = np.arange(len(self._batches))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        for i in order:
            yield self._batches[i]

    def __len__(self) -> int:
        if self._batches is not None:
            return len(self._batches)
        return len(self.inner)


# capacity ladder for packed batches: steps of about 1.06x, so a few
# shapes cover a run while padding stays under 6 %
_PACKED_BUCKETS = tuple(sorted({
    (1 << k) * m // 16 for k in range(4, 26) for m in range(16, 32)
}))


@dataclasses.dataclass
class PackedLoader:
    """Yields PackedGraphBatch objects (flat node and edge arrays with
    segment ids) padded to capacities of the _PACKED_BUCKETS ladder and
    to batch_size graphs, on ``device`` (default cuda): the layout of the
    packed models (nn/packed.py PackedGNN, PackedLGGNN). An operator
    reads int32 indices, 4 bytes an edge, where the dense line-graph path
    multiplies by one-hot scatter matrices.

    shuffle and sort as DenseLoader's. uniform_caps (default) gives every
    batch of an epoch the one (node, edge) capacity of its largest batch,
    so a split is one shape group (training.train.group_batches);
    uniform_caps=False buckets each batch's own load. Compose with
    CachedLoader like DenseLoader."""

    records: Sequence[GraphRecord]
    batch_size: int
    task: int | None = None
    sort: bool = True
    shuffle: bool = False
    seed: int = 0
    uniform_caps: bool = True
    device: str | torch.device | None = None
    _epoch: int = 0

    def __iter__(self) -> Iterator[graphs.PackedGraphBatch]:
        idx = np.arange(len(self.records))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
            self._epoch += 1
        if self.sort:
            sizes = np.array([self.records[i].n_nodes for i in idx])
            idx = idx[np.argsort(sizes, kind="stable")]
        chunks = [[self.records[i] for i in idx[s : s + self.batch_size]]
                  for s in range(0, len(idx), self.batch_size)]
        caps = [(sum(r.n_nodes for r in c), sum(r.n_dir_edges for r in c))
                for c in chunks]
        if self.uniform_caps and caps:
            caps = [(max(v for v, _ in caps), max(e for _, e in caps))] * len(caps)
        for chunk, (v, e) in zip(chunks, caps):
            yield graphs.make_packed_batch(
                chunk, node_capacity=pad_to_bucket(v, _PACKED_BUCKETS),
                edge_capacity=pad_to_bucket(e, _PACKED_BUCKETS),
                task=self.task, batch_size=self.batch_size,
                device=self.device)

    def __len__(self) -> int:
        return (len(self.records) + self.batch_size - 1) // self.batch_size


VERTEX_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)


@dataclasses.dataclass
class CCNLoader:
    """Yields CCNBatch objects with a static vertex capacity per batch, on
    ``device`` (default cuda)."""

    records: Sequence[GraphRecord]
    batch_size: int
    task: int | None = None
    k_max: int | None = None
    vertex_buckets: Sequence[int] = VERTEX_BUCKETS
    shuffle: bool = False
    seed: int = 0
    add_self_loops: bool = True
    device: str | torch.device | None = None
    _epoch: int = 0

    def __post_init__(self):
        if self.k_max is None:
            # global max receptive-field size so every batch shares one K
            bump = 1 if self.add_self_loops else 0
            self.k_max = max(r.max_degree() + bump for r in self.records)

    def __iter__(self) -> Iterator[ccn_mod.CCNBatch]:
        idx = np.arange(len(self.records))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
            self._epoch += 1
        for s in range(0, len(idx), self.batch_size):
            chunk = [self.records[i] for i in idx[s : s + self.batch_size]]
            cap = pad_to_bucket(sum(r.n_nodes for r in chunk),
                                self.vertex_buckets)
            yield ccn_mod.make_ccn_batch(
                chunk,
                k_max=self.k_max,
                vertex_capacity=cap,
                add_self_loops=self.add_self_loops,
                task=self.task,
                batch_size=self.batch_size,
                device=self.device,
            )

    def __len__(self) -> int:
        return (len(self.records) + self.batch_size - 1) // self.batch_size
