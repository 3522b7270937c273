"""Edge-partitioned execution of the packed models (counterpart of the
edge-axis half of hgnn2_tpu/parallel/spmd.py).

The packed edge set is split over the S ranks of an EdgeMesh: rank r takes
the contiguous edge slots [r*C/S, (r+1)*C/S), as P("edge") cuts the
leading axis in JAX. Node and edge states stay replicated. Every operator
application whose output lives on nodes is one rank-local segment sum and
one all-reduce of the (V, F) node block; per-edge arithmetic (the NB
operator's reverse-edge term, the Pm^T/Pd^T gathers) needs none.

The JAX package drives every device of a shard_map from one process, and
so does the port: an EdgeMesh is a list of rank devices in one process.
So far all ranks must sit on one device (every rank ``cuda:0`` on a card,
``cpu`` on the host), where the all-reduce is kernel K5 over the ranks'
buffers (ops/ring.py) or a plain sum. Ranks on several cards come with the
multi-device slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from hgnn2_torch.graphs import PackedGraphBatch
from hgnn2_torch.ops import sparse
from hgnn2_torch.ops.ring import ring_psum


def _indexed(dev: torch.device) -> torch.device:
    """'cuda' names the current card, as tensors moved there report it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class EdgeMesh:
    """S rank devices along one 'edge' axis (counterpart of
    Mesh(devices, ("edge",)))."""

    def __init__(self, devices: Sequence[str | torch.device]):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("an EdgeMesh needs at least one rank")
        if len(set(self.devices)) != 1:
            raise NotImplementedError(
                f"ranks on several devices ({sorted(map(str, set(self.devices)))}) "
                "come with slice F (peer-mapped rings, NCCL); every rank of "
                "an EdgeMesh sits on one device so far")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def edge_bounds(num_edges: int, n_ranks: int) -> list[tuple[int, int]]:
    """Rank r's edge slots [lo, hi): equal contiguous blocks."""
    if num_edges % n_ranks:
        raise ValueError(f"edge capacity {num_edges} is not divisible by "
                         f"{n_ranks} ranks (pad_edges_for_partition)")
    c = num_edges // n_ranks
    return [(r * c, (r + 1) * c) for r in range(n_ranks)]


def _plain_reduce(parts: list[torch.Tensor]) -> torch.Tensor:
    """Sum over ranks (the counterpart of lax.psum, XLA's in JAX)."""
    return torch.stack(parts).sum(0)


def _check_device(mesh: EdgeMesh, t: torch.Tensor) -> None:
    if t.device != mesh.device:
        raise ValueError(f"inputs on {t.device}, mesh ranks on {mesh.device}")


def partitioned_spmm(mesh: EdgeMesh, num_nodes: int):
    """Edge-partitioned SpMM: each rank aggregates its block of edges and a
    plain reduce over ranks assembles the full result. Returns
    f(src, dst, w, x) -> (V, F)."""

    def apply(src, dst, w, x):
        _check_device(mesh, x)
        parts = [sparse.spmm(src[lo:hi], dst[lo:hi], w[lo:hi], x, num_nodes)
                 for lo, hi in edge_bounds(src.shape[0], mesh.size)]
        return _plain_reduce(parts)

    return apply


def partitioned_graph_op(mesh: EdgeMesh, num_nodes: int, J: int):
    """Edge-partitioned [X | dX | AX | A^2X ...]: ops.sparse.graph_op with
    the edge set split over the mesh."""
    spmm = partitioned_spmm(mesh, num_nodes)

    def apply(src, dst, w, x):
        deg = spmm(src, dst, w, x.new_ones((x.shape[0], 1)))[:, 0]
        return sparse.power_blocks(x, deg, lambda c: spmm(src, dst, w, c), J)

    return apply


class PartitionedPackedOps:
    """Edge-partitioned operator bundle for PackedLGGNN/PackedGNN: the
    SparsePackedOps interface with the edge set split over the ranks of
    ``mesh``. use_ring takes K5 (ops/ring.ring_psum, no gradient) for
    every all-reduce in place of the plain sum over ranks."""

    def __init__(self, mesh: EdgeMesh, pb: PackedGraphBatch, J: int,
                 use_ring: bool = False):
        _check_device(mesh, pb.x)
        self.mesh, self.pb, self.J, self.use_ring = mesh, pb, J, use_ring
        self.V = pb.num_node_slots
        self.bounds = edge_bounds(pb.num_edge_slots, mesh.size)
        # every node-block all-reduce is logged, so the volume is counted
        self.psum_widths: list[int] = []
        # the degree once per bundle; the NB degree derives from it with
        # no extra all-reduce: dl[e] = deg[dst(e)] - w(rev(e))
        self.deg = self._seg(pb.src, pb.w[:, None])[:, 0]
        self.dl = (self.deg[pb.dst] - pb.w[pb.rev]) * pb.edge_mask

    def _seg(self, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """Rank-local segment sums of each rank's edge block, then one
        all-reduce; returns rank 0's replica (the copy JAX hands back for
        out_specs=P() with check_rep=False)."""
        self.psum_widths.append(int(vals.shape[1]))
        parts = [sparse.segment_sum(vals[lo:hi], idx[lo:hi], self.V)
                 for lo, hi in self.bounds]
        if self.use_ring:
            return ring_psum(parts)[0]
        return _plain_reduce(parts)

    def _spmm(self, x):
        pb = self.pb
        return self._seg(pb.src, pb.w[:, None] * x[pb.dst])

    def graph_op(self, x):
        return sparse.power_blocks(x, self.deg, self._spmm, self.J)

    def _nb(self, xl):
        pb = self.pb
        y = self._seg(pb.src, pb.w[:, None] * xl)
        out = y[pb.dst] - pb.w[pb.rev][:, None] * xl[pb.rev]
        return out * pb.edge_mask[:, None]

    def lg_graph_op(self, xl):
        return sparse.power_blocks(xl, self.dl, self._nb, self.J)

    def pm(self, xl):
        xm = xl * self.pb.edge_mask[:, None]
        return self._seg(self.pb.src, xm) + self._seg(self.pb.dst, xm)

    def pd(self, xl):
        xm = xl * self.pb.edge_mask[:, None]
        return self._seg(self.pb.src, xm) - self._seg(self.pb.dst, xm)

    def pm_t(self, x):
        pb = self.pb
        return sparse.incidence_t_apply(pb.src, pb.dst, pb.edge_mask, x, False)

    def pd_t(self, x):
        pb = self.pb
        return sparse.incidence_t_apply(pb.src, pb.dst, pb.edge_mask, x, True)

    def nb_degrees(self):
        return self.dl

    def comm_bytes_per_step(self, dtype_bytes: int = 4) -> dict:
        """All-reduce volume of the forwards run through this bundle so
        far. A ring all-reduce of a replicated (V, width) block moves
        2 (n-1)/n V width dtype_bytes per chip; a train step's backward
        doubles it."""
        n = self.mesh.size
        ring = 2.0 * (n - 1) / max(n, 1)
        fwd = sum(ring * self.V * wd * dtype_bytes for wd in self.psum_widths)
        return {
            "n_allreduce_fwd": len(self.psum_widths),
            "forward_bytes_per_chip": fwd,
            "train_step_bytes_per_chip": 2 * fwd,
            "ring_factor": ring,
        }


# the JAX package's name for the bundle's constructor
partitioned_packed_ops = PartitionedPackedOps


def pad_edges_for_partition(arrays: dict, n_shards: int, num_nodes: int) -> dict:
    """Pads packed edge arrays (numpy) so the edge count divides n_shards.

    Padding edges carry weight 0 and point at node num_nodes - 1; padded
    rev slots are self-referential, as make_packed_batch pads. arrays:
    src, dst, w and optionally rev, edge_gid, edge_mask or others (padded
    with zeros)."""
    c = len(arrays["src"])
    target = ((c + n_shards - 1) // n_shards) * n_shards
    pad = target - c
    if pad == 0:
        return dict(arrays)
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if k in ("src", "dst"):
            fill = np.full((pad,), num_nodes - 1, v.dtype)
        elif k == "rev":
            fill = np.arange(c, c + pad, dtype=v.dtype)
        else:
            fill = np.zeros((pad,) + v.shape[1:], v.dtype)
        out[k] = np.concatenate([v, fill], axis=0)
    return out
