"""Partitioned execution of the packed models (counterpart of
hgnn2_tpu/parallel/spmd.py): the edge-partitioned half and the
molecule-aligned half.

Edge-partitioned: the packed edge set is split over the S ranks of an
EdgeMesh: rank r takes the contiguous edge slots [r*C/S, (r+1)*C/S), as
P("edge") cuts the leading axis in JAX. Node and edge states stay
replicated. Every operator application whose output lives on nodes is one
rank-local segment sum and one all-reduce of the (V, F) node block;
per-edge arithmetic (the NB operator's reverse-edge term, the Pm^T/Pd^T
gathers) needs none.

Molecule-aligned: molecules are dealt whole into edge-balanced shards
(partition_records) and each shard is packed on its own
(make_packed_shards: a PackedGraphBatch whose fields carry a leading
rank axis, or two for the hybrid (data, edge) layout). No molecule spans
two shards, so every operator apply stays inside a shard; only the
BatchNorm statistics and the loss's sums cross ranks, each through psum.

Data parallelism over dense batches (make_mesh, shard_batch, replicate,
ShardedLoader, make_dp_train_step; cli --dp M): JAX shards the padded
batch over the "data" axis and XLA computes the step of the global batch.

The JAX package drives every device of a shard_map from one process; the
port does so within a process: an EdgeMesh is a list of rank devices in
one process and a RankGrid a (data, edge) grid of ranks. Within a process
all ranks sit on one device (every rank ``cuda:0`` on a card, ``cpu`` on
the host). There the edge-partitioned all-reduce is kernel K5 over the
ranks' buffers (ops/ring.py) or a plain sum, the ranks of a molecule-aligned
batch run as one batch (flatten_shards lays them end to end, rank-major,
with each rank's indices moved past the ranks before it, so the model
runs once over all of them and every cross-rank sum is already whole),
and a dense batch sharded over "data" is the same batch, so the DP step
is the unsharded step. A RankGrid may also span processes
(parallel/multihost.py): then psum all-reduces over the process group of
each axis that crosses them, all_gather gathers over it, and a step sums
the replicated parameters' gradients over the processes in one place
(backward). Ranks on several devices are PyTorch's one rank a process
(F4): an EdgeMesh over processes (multihost.edge_mesh) holds one rank in
each, and the edge-partitioned ops compute this process's edge block and
reduce it over the processes, through K5 across them (ring.ProcessRing)
or the differentiable all-reduce. Several devices in one process raise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch.distributed as dist

import numpy as np
import torch
import torch.nn.functional as F

from hgnn2_torch import resolve_device
from hgnn2_torch.graphs import PackedGraphBatch
from hgnn2_torch.ops import sparse
from hgnn2_torch.ops.ring import ProcessRing, gather_parts, ring_psum


def _indexed(dev: torch.device) -> torch.device:
    """'cuda' names the current card, as tensors moved there report it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class EdgeMesh:
    """S ranks along one 'edge' axis (counterpart of Mesh(devices,
    ("edge",))).

    EdgeMesh(devices): the S ranks in this process, every one on the same
    device. EdgeMesh([device], grid): one rank of S in each process of
    ``grid`` (a RankGrid of 1 x S ranks over processes, one a process:
    multihost.edge_mesh), this process's on ``device``; ``rank`` is its
    index, and ``ring`` the process ring (K5 across processes) over the
    grid's edge group."""

    def __init__(self, devices: Sequence[str | torch.device],
                 grid: "RankGrid | None" = None):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("an EdgeMesh needs at least one rank")
        if len(set(self.devices)) != 1:
            raise NotImplementedError(
                f"ranks on several devices ({sorted(map(str, set(self.devices)))}) "
                "of one process: slice F4 runs them one rank a process "
                "(multihost.edge_mesh); every rank of an EdgeMesh in one "
                "process sits on one device")
        self.grid, self.rank, self.ring = grid, 0, None
        self.size = len(self.devices)
        if grid is not None:
            if (len(self.devices) != 1 or grid.shape["data"] != 1
                    or grid.local["edge"] != 1 or "edge" not in grid.groups):
                raise ValueError("an EdgeMesh over processes holds one rank "
                                 "a process of a 1 x S grid whose edge axis "
                                 "spans them")
            self.size, self.rank = grid.shape["edge"], grid.axis_index("edge")
            self.ring = ProcessRing(grid.groups["edge"])

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def blocks(self, num_edges: int) -> list[tuple[int, int]]:
        """The edge blocks this process computes: every rank's in one
        process, its own rank's over processes."""
        bounds = edge_bounds(num_edges, self.size)
        return bounds if self.grid is None else [bounds[self.rank]]

    def reduce(self, parts: list[torch.Tensor],
               use_ring: bool = False) -> torch.Tensor:
        """The sum over the ranks of the blocks' partials (``blocks``):
        in one process K5 over them (rank 0's replica) or a plain sum;
        over processes K5 across them (this rank's replica) or the
        differentiable all-reduce over the edge group."""
        if self.grid is None:
            return ring_psum(parts)[0] if use_ring else _plain_reduce(parts)
        (part,) = parts
        if use_ring:
            return self.ring(part)
        return _AllReduce.apply(part, self.grid, "edge")


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
                 for lo, hi in mesh.blocks(src.shape[0])]
        return mesh.reduce(parts)

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
    ``mesh``. use_ring takes K5 (ops/ring.ring_psum, or
    ring.ProcessRing over processes; no gradient) for every all-reduce in
    place of the plain sum over ranks. Over processes each computes only
    its own rank's edge block and keeps its own replica of every sum."""

    def __init__(self, mesh: EdgeMesh, pb: PackedGraphBatch, J: int,
                 use_ring: bool = False):
        _check_device(mesh, pb.x)
        self.mesh, self.pb, self.J, self.use_ring = mesh, pb, J, use_ring
        self.V = pb.num_node_slots
        self.bounds = mesh.blocks(pb.num_edge_slots)
        # every node-block all-reduce is logged, so the volume is counted
        self.psum_widths: list[int] = []
        # the degree once per bundle; the NB degree derives from it with
        # no extra all-reduce: dl[e] = deg[dst(e)] - w(rev(e))
        self.deg = self._seg(pb.src, pb.w[:, None])[:, 0]
        self.dl = ((sparse.gather(self.deg, pb.dst)
                    - sparse.gather(pb.w, pb.rev)) * pb.edge_mask)

    def _seg(self, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """Rank-local segment sums of each rank's edge block, then one
        all-reduce (EdgeMesh.reduce); in one process returns rank 0's
        replica (the copy JAX hands back for out_specs=P() with
        check_rep=False), over processes this rank's (the copy JAX's
        device r goes on with)."""
        self.psum_widths.append(int(vals.shape[1]))
        parts = [sparse.segment_sum(vals[lo:hi], idx[lo:hi], self.V)
                 for lo, hi in self.bounds]
        return self.mesh.reduce(parts, self.use_ring)

    def _spmm(self, x):
        pb = self.pb
        return self._seg(pb.src, pb.w[:, None] * sparse.gather(x, pb.dst))

    def graph_op(self, x):
        return sparse.power_blocks(x, self.deg, self._spmm, self.J)

    def _nb(self, xl):
        pb = self.pb
        y = self._seg(pb.src, pb.w[:, None] * xl)
        w_rev = sparse.gather(pb.w, pb.rev)[:, None]
        out = sparse.gather(y, pb.dst) - w_rev * sparse.gather(xl, pb.rev)
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


# ---------------------------------------------------------------------------
# Molecule-aligned sharding (no exchange per operator apply)
# ---------------------------------------------------------------------------

AXES = ("data", "edge")

# the grids entered with ``with grid:``, innermost last (psum reads it)
_ACTIVE: list["RankGrid"] = []


def device_count(dev: torch.device) -> int:
    """The devices of dev's type that "0 = all" flags count: the cards
    for cuda, 1 for the CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


class RankGrid:
    """M x N ranks along the axes ("data", "edge") (counterpart of
    Mesh(devices.reshape(M, N), ("data", "edge"))).

    In one process (the default) every rank sits on ``device``, as an
    EdgeMesh's do. A grid over several processes (multihost.global_mesh)
    holds, for each axis whose ranks lie in more than one process, the
    torch.distributed process group along it (``groups``; None stands for
    the default group of every process), spans ``n_processes`` processes
    and keeps ``local`` = (M, N) of its ranks in this one, on its
    ``device``. Entered as a context (``with grid:``) it is the grid whose
    groups psum reduces over, as a shard_map's mesh is for lax.psum; the
    step functions enter it. ``comm`` counts the cross-process collectives
    (calls and bytes): psum's all-reduces, forward and backward, the
    gradient sums (sum_grads) and all_gather's gathers (the bytes
    gathered) and their adjoints' all-reduces."""

    axis_names = AXES

    def __init__(self, n_data: int = 1, n_edge: int = 1,
                 device: str | torch.device | None = None,
                 groups: dict | None = None,
                 local: tuple[int, int] | None = None, n_processes: int = 1):
        if n_data < 1 or n_edge < 1:
            raise ValueError(f"a rank grid needs at least one rank an axis; "
                             f"got ({n_data}, {n_edge})")
        self.shape = {"data": n_data, "edge": n_edge}
        self.device = _indexed(resolve_device(device))
        self.groups = dict(groups or {})
        mesh_axes(tuple(self.groups) or AXES)
        self.local = dict(zip(AXES, local or (n_data, n_edge)))
        self.n_processes = n_processes
        self.comm = dict.fromkeys(("psum_calls", "psum_bytes", "grad_calls",
                                   "grad_bytes", "gather_calls",
                                   "gather_bytes"), 0)

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["edge"]

    def __enter__(self) -> "RankGrid":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def check(self, stacked, axes) -> None:
        """Raises unless the stacked batch's leading rank dims are this
        process's ranks along ``axes`` and it lies on the grid's device,
        as a shard_map over those axes requires."""
        want = tuple(self.local[a] for a in mesh_axes(axes))
        got = tuple(stacked.gmask.shape[:len(want)])
        if got != want:
            raise ValueError(f"stacked ranks {got}, the grid's {axes} are "
                             f"{want}" + (" in this process" if self.groups
                                          else ""))
        if stacked.gmask.device != self.device:
            raise ValueError(f"batch on {stacked.gmask.device}, ranks on "
                             f"{self.device}")

    def axis_index(self, axis: str) -> int:
        """The index along ``axis`` of this process's first rank."""
        if axis not in self.groups:
            return 0
        return dist.get_rank(self.groups[axis]) * self.local[axis]

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Every process's t along ``axis``, concatenated on dim 0 in the
        processes' order (ring.gather_parts), on t's device; counted
        under "gather"."""
        out = torch.cat(gather_parts(t, self.groups[axis])).to(t.device)
        self.comm["gather_calls"] += 1
        self.comm["gather_bytes"] += out.numel() * out.element_size()
        return out

    def all_reduce(self, t: torch.Tensor, axis: str | None,
                   kind: str = "psum") -> torch.Tensor:
        """t (contiguous), summed in place over the processes along
        ``axis`` (None: every process of the grid), counted under kind."""
        group = self.groups.get(axis) if axis is not None else None
        dist.all_reduce(t, group=group)
        self.comm[f"{kind}_calls"] += 1
        self.comm[f"{kind}_bytes"] += t.numel() * t.element_size()
        return t

    def sum_grads(self, params) -> None:
        """The replicated parameters' gradients summed over the grid's
        processes: one all-reduce of them laid end to end."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads or not self.groups:
            return
        flat = self.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                               None, "grad")
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def mesh_axes(axis_name) -> tuple[str, ...]:
    """axis_name (a mesh axis or a tuple of them) as a tuple; raises for
    a name that is not one of AXES."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if not names or any(n not in AXES for n in names):
        raise ValueError(f"mesh axes {names!r}: each must be one of {AXES}")
    return names


class _AllReduce(torch.autograd.Function):
    """The sum over the processes along one axis of a grid, forward and
    backward. Every process that holds a copy of the sum may use it, so
    its adjoint is the sum of each process's; a result every process
    holds the same copy of (the loss) is then counted once a process,
    which backward() undoes by backpropagating loss / n_processes."""

    @staticmethod
    def forward(ctx, x, grid, axis):
        ctx.grid, ctx.axis = grid, axis
        return grid.all_reduce(x.detach().clone(
            memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.all_reduce(g.clone(
            memory_format=torch.contiguous_format), ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    """The processes' x along one axis of a grid laid end to end
    (lax.all_gather, tiled). Its adjoint is a reduce-scatter: each
    process's share of the sum of every process's adjoint, here an
    all-reduce and this process's slice (gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, grid, axis):
        ctx.grid, ctx.axis, ctx.n = grid, axis, x.shape[0]
        return grid.all_gather(x.detach(), axis)

    @staticmethod
    def backward(ctx, g):
        full = ctx.grid.all_reduce(g.clone(
            memory_format=torch.contiguous_format), ctx.axis, "gather")
        k = dist.get_rank(ctx.grid.groups[ctx.axis])
        return full[k * ctx.n:(k + 1) * ctx.n], None, None


def all_gather(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The blocks x of every rank along the mesh axis ``axis_name`` laid
    end to end on dim 0, in rank order (JAX's lax.all_gather(x, axis,
    tiled=True)). In one process x already holds this process's ranks'
    blocks, which are all of them, and comes back as it is; inside ``with
    grid:`` for a grid whose axis spans processes, the processes' x are
    gathered over its group (_AllGather, differentiable)."""
    (name,) = mesh_axes(axis_name)
    grid = _ACTIVE[-1] if _ACTIVE else None
    if grid is not None and name in grid.groups:
        return _AllGather.apply(x, grid, name)
    return x


def psum(x: torch.Tensor, axis_name, ranked: int = 0) -> torch.Tensor:
    """The sum of x over the ranks of the mesh axes ``axis_name`` (a name
    or a tuple of names; JAX's lax.psum). Every cross-rank reduction of
    the molecule-aligned and data-parallel paths passes through here:
    BatchNorm's count, total and squared deviations, the loss's and the
    metrics' sums.

    The ranks of this process: x either carries them on its ``ranked``
    leading dims, which are summed, or (ranked=0) already holds the sum
    over them, the ranks having been flattened into one batch
    (flatten_shards), or the batch being the process's whole share of a
    dense data-parallel batch. Then, inside ``with grid:`` for a grid that
    spans processes, the sum is all-reduced over the process group of
    each axis of axis_name that crosses them (_AllReduce, differentiable;
    the step backpropagates through backward())."""
    names = mesh_axes(axis_name)
    if ranked:
        x = x.sum(dim=tuple(range(ranked)))
    grid = _ACTIVE[-1] if _ACTIVE else None
    if grid is not None:
        for name in names:
            if name in grid.groups:
                x = _AllReduce.apply(x, grid, name)
    return x


def backward(loss: torch.Tensor, grid: RankGrid | None, params) -> None:
    """loss.backward() for the step of ``grid``. Over processes every
    process holds the same loss: each backpropagates loss / n_processes
    through psum's all-reduces, then the replicated parameters' gradients
    are summed over the processes (grid.sum_grads, the one place a step
    sums them), so each equals the gradient of the one global loss, not
    n_processes times it. In one process, loss.backward()."""
    if grid is None or not grid.groups:
        loss.backward()
        return
    (loss / grid.n_processes).backward()
    grid.sum_grads(params)


def per_graph_loss(out: torch.Tensor, y: torch.Tensor, kind: str,
                   mean: float, std: float) -> torch.Tensor:
    """Each graph's loss: cross-entropy of its logits, or the squared
    error against its mean/std-normalized target."""
    if kind == "classification":
        return F.cross_entropy(out, y.long(), reduction="none")
    return (out[:, 0] - (y - mean) / (std + 1e-8)) ** 2


def metric_sums(out, y, gmask, kind: str, mean: float, std: float,
                n_ranks: int = 1, axes=("edge",)):
    """Each rank's masked sums of (loss, metric) over its real graphs and
    its real-graph count, summed over the ranks of ``axes`` (psum); the
    graphs are rank-major, n_ranks of them in this process. Returns (num
    (2,), den): den is the RAW real-graph count, so an all-padding batch
    counts 0; only the division sites clamp it."""
    per = per_graph_loss(out, y, kind, mean, std)
    if kind == "classification":
        metric = (out.argmax(-1) == y).float()
    else:
        metric = (out[:, 0] - (y - mean) / (std + 1e-8)).abs()
    num = (torch.stack([per, metric], 1) * gmask[:, None]).reshape(
        n_ranks, -1, 2).sum(1)
    den = gmask.reshape(n_ranks, -1).sum(1)
    return psum(num, axes, 1), psum(den, axes, 1)


# ---------------------------------------------------------------------------
# Data parallelism over dense batches (the "data" axis)
# ---------------------------------------------------------------------------


def make_mesh(n_devices: int | None = None, edge_axis: int = 1,
              devices=None) -> RankGrid:
    """A ("data", "edge") grid of n_devices ranks, (n / edge_axis,
    edge_axis). Every rank sits on one device: ``devices`` names it (a
    device, or a sequence that repeats one device; default cuda), and
    n_devices defaults to the devices of its type (or the sequence's
    length). Ranks on several devices run one rank a process
    (multihost.global_mesh); here they raise."""
    if devices is None or isinstance(devices, (str, torch.device)):
        dev = resolve_device(devices)
        avail = device_count(dev)
    else:
        devs = {_indexed(torch.device(d)) for d in devices}
        if len(devs) != 1:
            raise NotImplementedError(
                f"ranks on several devices ({sorted(map(str, devs))}) of one "
                "process: F4 runs them one rank a process "
                "(multihost.global_mesh)")
        dev, avail = next(iter(devs)), len(devices)
    n = n_devices or avail
    if n % edge_axis != 0:
        raise ValueError(f"n_devices {n} not divisible by edge axis {edge_axis}")
    return RankGrid(n // edge_axis, edge_axis, dev)


def shard_batch(mesh: RankGrid, batch):
    """Every tensor field of a batch split on its leading (batch) axis
    over the grid's "data" ranks of this process; 0-d fields replicate.
    The ranks share the grid's device, so the batch moves there whole,
    its split checked: a leading axis that the "data" ranks do not divide
    raises ValueError, as JAX's device_put to the sharding does."""
    n = mesh.local["data"]
    fields = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, torch.Tensor):
            if v.dim() and v.shape[0] % n:
                raise ValueError(f"{f.name}: batch axis {v.shape[0]} not "
                                 f"divisible by the {n} data ranks")
            fields[f.name] = v.to(mesh.device)
    return dataclasses.replace(batch, **fields)


def replicate(mesh: RankGrid, tree):
    """A module (moved in place and returned), a tensor, or a dict, list
    or tuple of them, on the grid's device: every rank's copy."""
    if isinstance(tree, (torch.nn.Module, torch.Tensor)):
        return tree.to(mesh.device)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return tree


class ShardedLoader:
    """Wraps a batch loader so every yielded batch is sharded on its
    leading (batch) axis over the grid's "data" ranks (shard_batch).
    Composes under data.batching.CachedLoader, which then caches the
    sharded batches: the trainer's DP path."""

    def __init__(self, inner, mesh: RankGrid):
        self.inner = inner
        self.mesh = mesh

    def __iter__(self):
        for batch in self.inner:
            yield shard_batch(self.mesh, batch)

    def __len__(self) -> int:
        return len(self.inner)


def make_dp_train_step(train_step, mesh: RankGrid):
    """A train step (training.train.make_train_step) for data
    parallelism over ``mesh``. JAX's step of a batch sharded over "data"
    computes, under XLA's global semantics, the single-device step of the
    whole batch; so is the port's, train_step itself. In one process the
    ranks share one device and the batch is whole (its CUDA graphs
    included). Over processes each holds its rows of the global batch,
    and train_step must be built over the grid (make_train_step(...,
    grid=mesh)): its loss's and metrics' sums cross the processes (psum
    over "data"; the model's BatchNorm is built with axis_name "data"),
    its gradients are summed once (backward), and it runs eagerly."""
    if mesh.groups and train_step.grid is not mesh:
        raise ValueError("a grid over processes needs the step built over "
                         "it: make_train_step(..., grid=mesh)")
    return train_step


def partition_records(records, n_shards: int) -> list[list]:
    """Greedy bin-packing of molecules into n_shards shards balanced by
    directed-edge count, largest first, each to the least loaded shard
    (the first of equals). A molecule is never split, so the cut is
    empty. The shards and their order equal the JAX package's."""
    order = sorted(range(len(records)), key=lambda i: -records[i].n_dir_edges)
    shards: list[list] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for i in order:
        k = loads.index(min(loads))
        shards[k].append(records[i])
        loads[k] += records[i].n_dir_edges
    return shards


def _tensor_fields(batch) -> list[str]:
    return [f.name for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)]


def stack_shards(batches: Sequence, device=None):
    """Batches of one shape (PackedGraphBatch or CCNBatch) stacked on a
    new leading rank axis, on ``device`` (default: where they are); the
    other fields (n_graphs) from the first."""
    return dataclasses.replace(batches[0], **{
        name: torch.stack([getattr(b, name) for b in batches]).to(device)
        for name in _tensor_fields(batches[0])})


def padding_dims(records, task):
    """(feature_dim, y_dtype) of the records, for empty shards' padding."""
    if not records:
        return None, None
    y0 = np.asarray(records[0].y if task is None else records[0].y[task])
    y_dtype = y0.dtype if np.issubdtype(y0.dtype, np.integer) else np.float32
    return records[0].x.shape[1], y_dtype


def make_packed_shards(records, n_shards: int, node_capacity: int,
                       edge_capacity: int, graphs_per_shard: int,
                       task: int | None = None, parts=None,
                       device: str | torch.device | None = None
                       ) -> PackedGraphBatch:
    """The molecules partitioned into n_shards edge-balanced shards
    (partition_records, or ``parts`` when the caller has partitioned
    already), each packed at the given capacities and graphs_per_shard
    graph slots, stacked on a leading rank axis: a PackedGraphBatch of
    (S, ...) fields, n_graphs = graphs_per_shard, each shard's indices
    local to it. A shard with no molecule is all padding. Built on the
    host and moved to ``device`` (default cuda) once; every array equals
    the JAX package's."""
    from hgnn2_torch import graphs as graphs_lib

    dev = resolve_device(device)
    if parts is None:
        parts = partition_records(records, n_shards)
    feature_dim, y_dtype = padding_dims(records, task)
    batches = []
    for part in parts:
        if len(part) > graphs_per_shard:
            raise ValueError(f"shard holds {len(part)} graphs > "
                             f"graphs_per_shard={graphs_per_shard}")
        batches.append(graphs_lib.make_packed_batch(
            part, node_capacity=node_capacity, edge_capacity=edge_capacity,
            task=task, batch_size=graphs_per_shard, feature_dim=feature_dim,
            y_dtype=y_dtype, device="cpu"))
    return stack_shards(batches, dev)


_NODE_INDEX = ("src", "dst", "nbr")  # global vertex indices of a shard
_EDGE_INDEX = ("rev",)  # edge slot indices
_GRAPH_ID = ("node_gid", "edge_gid", "gid")  # graph ids, padding = n_graphs


def flatten_shards(stacked, lead: int = 1):
    """One batch of every rank of a stacked batch of molecule-aligned
    shards (make_packed_shards, ccn_parallel.make_ccn_shards): ``lead``
    leading rank dims (1 for (S, ...), 2 for the hybrid (M, N, ...))
    become R ranks laid end to end, rank-major (rank r = d N + e). Rank r's
    vertex indices (src, dst, CCN nbr) move by r Vl, its edge indices
    (rev) by r El and its real graph ids by r Gl; graph-id padding (Gl in
    a shard) maps to the one drop slot R Gl, which n_graphs = R Gl makes
    the readouts drop, not onto the next rank's first graph. The CCN
    tables chi_idx and rslot hold slots, not vertices, and their -1
    sentinels stay. Padded edges keep pointing at their own rank's last
    node and at themselves. Runs on the device (a few elementwise ops, no
    host sync)."""
    x = stacked.x
    R = int(np.prod(x.shape[:lead]))
    Vl, Gl = x.shape[lead], stacked.gmask.shape[lead]
    rank = torch.arange(R, device=x.device, dtype=torch.int32)

    def ranked(t):  # (R, n, ...)
        return t.reshape((R,) + t.shape[lead:])

    def offset(t, step):
        t = ranked(t)
        return t + (rank * step).reshape((R,) + (1,) * (t.dim() - 1))

    out = {}
    for name in _tensor_fields(stacked):
        t = getattr(stacked, name)
        if name in _NODE_INDEX:
            t = offset(t, Vl)
        elif name in _EDGE_INDEX:
            t = offset(t, t.shape[lead])
        elif name in _GRAPH_ID:
            t = offset(t, Gl).masked_fill_(ranked(t) >= Gl, R * Gl)
        else:
            t = ranked(t)
        out[name] = t.reshape((-1,) + t.shape[2:])
    return dataclasses.replace(stacked, n_graphs=R * Gl, **out)


def local_partitioned_spmm(mesh: RankGrid, nodes_per_shard: int):
    """Molecule-aligned SpMM: f(src, dst, w, x) -> (S, Vl, F) for
    stacked (S, El) shard-local edges and (S, Vl, F) node features; each
    shard aggregates its own edges, with no exchange (the cut is empty).
    The shards run as one segment sum over their flattened blocks."""

    def apply(src, dst, w, x):
        S, Vl = x.shape[:2]
        if Vl != nodes_per_shard:
            raise ValueError(f"{Vl} nodes a shard, expected {nodes_per_shard}")
        off = (torch.arange(S, device=src.device, dtype=src.dtype)
               * nodes_per_shard)[:, None]
        out = sparse.spmm((src + off).reshape(-1), (dst + off).reshape(-1),
                          w.reshape(-1), x.reshape((S * Vl,) + x.shape[2:]),
                          S * Vl)
        return out.reshape(x.shape)

    return apply


def sharded_packed_loss(model, mesh: RankGrid | None = None,
                        kind: str = "regression", mean: float = 0.0,
                        std: float = 1.0):
    """loss_fn(stacked) -> the masked loss of a packed model (built with
    bn_axis="edge") over (S, ...) stacked molecule-aligned shards: each
    rank's sums of its real graphs' losses and of its real-graph count,
    each summed over the ranks (psum), then divided. Differentiable with
    respect to the model's parameters; the forward runs in train mode
    and updates the BN running statistics, as a train step does.
    ``mesh``, when given, checks the stack against its "edge" axis
    (RankGrid.check)."""

    def loss_fn(stacked):
        if mesh is not None:
            mesh.check(stacked, "edge")
        batch = flatten_shards(stacked, 1)
        model.train()
        per = per_graph_loss(model(batch), batch.y, kind, mean, std)
        S = stacked.gmask.shape[0]
        num = psum((per * batch.gmask).reshape(S, -1).sum(1), "edge", 1)
        den = psum(stacked.gmask.sum(1), "edge", 1)
        return num / den.clamp_min(1.0)

    return loss_fn
