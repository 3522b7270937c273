"""Several processes over torch.distributed (counterpart of
hgnn2_tpu/parallel/multihost.py).

N processes, each holding its ranks on its own device, form one grid of
ranks (a spmd.RankGrid over processes): data parallelism over a "data"
axis that spans them, with per-process record shards, molecule-aligned
shards over an "edge" axis that spans them, or the hybrid (data =
processes, edge = each process's ranks). Every cross-rank sum passes
through spmd.psum, which all-reduces over the process group of each
axis that crosses processes; a step sums the replicated parameters'
gradients over the processes once (spmd.backward). An edge axis of one
rank a process (edge_mesh) carries the edge-partitioned packed ops (F4):
each process computes its own edge block, and the all-reduces cross the
processes, through K5 across them (ring.ProcessRing, CUDA IPC) or the
differentiable all-reduce; halo ranks run one a process over
global_mesh(("edge",)).

The process group is torch.distributed's, started by setup_distributed
with an explicit backend: "nccl" for one card per process, "gloo" for the
CPU and for several processes sharing one card (NCCL refuses two ranks
on one device). gloo all-reduces and broadcasts CUDA tensors, which is
all the collectives here use. Tested on the CPU by launching local
processes (hgnn2_torch/scripts/dryrun_multihost.py).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import zlib

import torch
import torch.distributed as dist

from hgnn2_torch import resolve_device
from hgnn2_torch.parallel import spmd


def setup_distributed(coordinator_address: str | None = None,
                      num_processes: int | None = None,
                      process_id: int | None = None,
                      backend: str = "gloo", timeout_s: float = 300.0) -> None:
    """Joins this process to the process group of ``num_processes``
    processes, as ``process_id``, the first of them listening at
    ``coordinator_address`` ("host:port", or a tcp:// URL).

    The arguments default to the HGNN2_COORDINATOR, HGNN2_NUM_PROCESSES and
    HGNN2_PROCESS_ID environment variables; with none of the first two set
    this is a no-op (one process). backend: "gloo" (the CPU, or processes
    sharing one card) or "nccl" (one card per process)."""
    coordinator_address = coordinator_address or os.environ.get(
        "HGNN2_COORDINATOR")
    if num_processes is None and "HGNN2_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["HGNN2_NUM_PROCESSES"])
    if process_id is None and "HGNN2_PROCESS_ID" in os.environ:
        process_id = int(os.environ["HGNN2_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return  # one process, nothing to set up
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("setup_distributed needs the coordinator address, "
                         "the number of processes and this process's id; got "
                         f"{coordinator_address!r}, {num_processes!r}, "
                         f"{process_id!r}")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shard_records(records, num_processes: int | None = None,
                  process_index: int | None = None):
    """This process's subset of the dataset, strided (records[p::P]) so
    every process sees the same molecule-size distribution. Each process
    builds batches only from its own shard."""
    if num_processes is None:
        num_processes = process_count()
    if process_index is None:  # JAX's argument name hides process_index()
        process_index = dist.get_rank() if dist.is_initialized() else 0
    return records[process_index::num_processes]


def _group(ranks: list[int], world: int):
    """The process group of ``ranks``: None (the default group) when it
    holds every process. Every process must call this for every group,
    in the same order (dist.new_group's rule)."""
    return None if len(ranks) == world else dist.new_group(ranks)


def global_mesh(axis_names=("data",), shape=None, local_ranks: int = 1,
                device=None) -> spmd.RankGrid:
    """The grid of every process's ranks: ``local_ranks`` ranks a process
    on its ``device`` (default cuda), process p holding the global ranks
    p*local_ranks ... in row-major order. Default: one "data" axis over
    all of them; ("edge",) puts them on the edge axis; ("data", "edge")
    with shape=(M, N) factors them, e.g. (processes, local_ranks) for the
    hybrid. A process must hold whole rows (edge within the process) or a
    run of one row; the groups of the axes that cross processes are made
    here, so every process calls this with the same arguments."""
    names = spmd.mesh_axes(axis_names)
    n_proc, p = process_count(), process_index()
    total = n_proc * local_ranks
    if names == ("data",) or names == ("edge",):
        m, n = (total, 1) if names == ("data",) else (1, total)
        if shape is not None and tuple(shape) != (total,):
            raise ValueError(f"shape {shape} for {total} ranks")
    elif names == spmd.AXES:
        m, n = shape if shape is not None else (total, 1)
    else:
        raise ValueError(f"axis names {names}: ('data',), ('edge',) or "
                         f"{spmd.AXES}")
    if m * n != total:
        raise ValueError(f"shape ({m}, {n}) for {n_proc} processes x "
                         f"{local_ranks} ranks")
    groups = {}
    if local_ranks % n == 0:  # whole rows: the edge axis stays in a process
        local = (local_ranks // n, n)
        if n_proc > 1:
            groups["data"] = None
    elif n % local_ranks == 0:  # a run of one row
        local = (1, local_ranks)
        per_row = n // local_ranks
        if per_row > 1:
            rows = [[r * per_row + k for k in range(per_row)] for r in range(m)]
            made = [_group(g, n_proc) for g in rows]
            groups["edge"] = made[p // per_row]
        if m > 1:
            cols = [[r * per_row + k for r in range(m)] for k in range(per_row)]
            made = [_group(g, n_proc) for g in cols]
            groups["data"] = made[p % per_row]
    else:
        raise ValueError(f"{local_ranks} ranks a process fit neither whole "
                         f"rows nor one row of {n}")
    return spmd.RankGrid(m, n, resolve_device(device), groups=groups,
                         local=local, n_processes=n_proc)


def edge_mesh(device=None) -> spmd.EdgeMesh:
    """The edge axis of every process, one rank a process, this process's
    on its ``device`` (default cuda): F4's EdgeMesh over processes, whose
    edge-partitioned ops compute this process's edge block and reduce it
    over the processes (K5 across them, ring.ProcessRing, or the
    differentiable all-reduce). One process: an EdgeMesh of one rank.
    Every process calls it with the same arguments (global_mesh's rule)."""
    grid = global_mesh(("edge",), device=device)
    if not grid.groups:
        return spmd.EdgeMesh([grid.device])
    return spmd.EdgeMesh([grid.device], grid)


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _check_equal_shapes(mesh: spmd.RankGrid, tree) -> None:
    """Raises on every process unless all processes of the grid hold
    tensors of the same shapes and dtypes: a fixed-size all-reduce of the
    signature's hash (max and -min), so a mismatch is found before the
    first collective of a step, whose sizes would differ and hang."""
    if not mesh.groups:
        return
    sig = repr([(tuple(t.shape), str(t.dtype)) for t in _tensors(tree)])
    h = zlib.crc32(sig.encode())
    dev = "cpu" if dist.get_backend() == "gloo" else mesh.device
    t = torch.tensor([h, -h], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if int(t[0]) != -int(t[1]):
        raise ValueError("processes hold local batches of different shapes "
                         f"(this one: {sig}); pin the buckets (n_max, m_max, "
                         "capacities) so that every process's are equal")


def make_global_batch(mesh: spmd.RankGrid, local_batch, axis: str = "data"):
    """This process's rows of the global batch, sharded along ``axis``
    (batch dimension 0): each process keeps its local batch, moved to its
    device; the grid's psums join the rows. All processes must pass
    batches of equal shapes (static buckets or capacities); a process
    whose shapes differ raises here, on every process."""
    spmd.mesh_axes(axis)
    _check_equal_shapes(mesh, local_batch)
    if dataclasses.is_dataclass(local_batch):
        return dataclasses.replace(local_batch, **{
            f.name: getattr(local_batch, f.name).to(mesh.device)
            for f in dataclasses.fields(local_batch)
            if isinstance(getattr(local_batch, f.name), torch.Tensor)})
    return spmd.replicate(mesh, local_batch)


def replicate_to_mesh(mesh: spmd.RankGrid, tree):
    """A module (in place, returned), a tensor, or a dict, list or tuple
    of them on the grid's device, every process holding process 0's
    values (broadcast), so the replicated state starts equal."""
    tree = spmd.replicate(mesh, tree)
    if mesh.groups:
        with torch.no_grad():
            for t in (list(tree.parameters()) + list(tree.buffers())
                      if isinstance(tree, torch.nn.Module) else _tensors(tree)):
                dist.broadcast(t, src=0)
    return tree
