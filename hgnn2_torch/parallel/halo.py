"""Halo-exchange edge partitioning for one giant graph (counterpart of
hgnn2_tpu/parallel/halo.py).

parallel/spmd.py has two aggregation schemes: replicated node features
plus an all-reduce of the (V, F) block a apply (general), and molecule-
aligned shards (no exchange, only for disconnected batches). This module
covers the middle case, one connected graph too large to replicate:

  * nodes are split into contiguous ranges, one per rank;
  * every edge lives on its source's rank, so every aggregation output is
    rank-local;
  * each rank exports only the node rows (and, for the line-graph
    operators, the reverse-edge rows) that other ranks' edges reference
    (the halo); one all_gather of the padded export buffers replaces the
    all-reduce, cutting the exchange from O(V F) to O(S Hmax F).

The host-side partitioner is numpy and its tables equal the JAX
package's. In one process the S ranks sit on one device, as an
EdgeMesh's do, and run as one flattened batch: the ranks' export buffers
are gathered into the (S, Hx, F) stack that all_gather delivers to each
rank, and each rank's import table indexes into it, so the exchange keeps
its per-rank structure (comm_log records the widths JAX's trace records)
while BN's pooling over "edge" and the partial readouts' psum are
already whole. Over a grid whose "edge" axis spans processes (one rank
a process: multihost.global_mesh(("edge",))), each process runs its own
rank's rows of the global tables: its export buffer goes out through
spmd.all_gather (lax.all_gather, differentiable), and BN's pooling and
the partial readouts' sum through spmd.psum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hgnn2_torch import resolve_device
from hgnn2_torch.graphs import PackedGraphBatch
from hgnn2_torch.ops import sparse
from hgnn2_torch.parallel import spmd


@dataclasses.dataclass
class HaloPartition:
    """Tables for halo_partitioned_spmm; leading axis = rank."""

    src_local: torch.Tensor  # (S, El) int32 local node index of edge source
    dst_local: torch.Tensor  # (S, El) int32 index into [x_local | halo]
    w: torch.Tensor  # (S, El)
    export_idx: torch.Tensor  # (S, Hx) int32 local node ids to export
    import_flat: torch.Tensor  # (S, Hi) int32 into the (S*Hx) gathered rows
    nodes_per_shard: int
    n_imports: int

    @property
    def n_shards(self) -> int:
        return self.src_local.shape[0]


def _halo_exchange_tables(ref_shard, items, item_owner, item_local,
                          n_shards: int, id_space: int):
    """Export/import tables for one halo exchange.

    ref_shard/items: per-reference arrays (one entry per cut edge) of the
    REFERENCING rank and the referenced global item id. item_owner(ids)
    -> owning rank; item_local(ids) -> the item's index in its owner's
    export source array. Returns (export_idx (S, cap), import_flat
    (S, icap), icap, up, imp_slot): up is the sorted unique (rank, item)
    pair keys and imp_slot each pair's slot in its rank's item-sorted
    import list, for _remap_refs."""
    S = n_shards
    pair = ref_shard.astype(np.int64) * id_space + items
    up = np.unique(pair)
    imp_shard = up // id_space
    imp_item = up % id_space
    # export side: unique items grouped by owner, item-sorted within owner
    exp_items = np.unique(imp_item)
    exp_owner = np.asarray(item_owner(exp_items), np.int64)
    order = np.argsort(exp_owner, kind="stable")
    eo = exp_owner[order]
    counts = np.bincount(eo, minlength=S)
    cap = max(int(counts.max()) if exp_items.size else 0, 1)
    start = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(eo)) - start[eo]
    export_idx = np.zeros((S, cap), np.int32)
    export_idx[eo, slot] = np.asarray(
        item_local(exp_items[order]), np.int64).astype(np.int32)
    # flat slot of each export item in the (S*cap) gathered buffer,
    # aligned with the item-sorted exp_items for searchsorted lookups
    flat_by_item = np.zeros(len(exp_items), np.int64)
    flat_by_item[order] = eo * cap + slot
    # import side: up is sorted by (rank, item), so one pass gives every
    # rank's item-sorted import list
    icounts = np.bincount(imp_shard, minlength=S)
    icap = max(int(icounts.max()) if up.size else 0, 1)
    istart = np.concatenate([[0], np.cumsum(icounts)])
    imp_slot = np.arange(len(up)) - istart[imp_shard]
    import_flat = np.zeros((S, icap), np.int32)
    if up.size:
        pos = np.searchsorted(exp_items, imp_item)
        import_flat[imp_shard, imp_slot] = flat_by_item[pos].astype(np.int32)
    return export_idx, import_flat, icap, up, imp_slot


def _remap_refs(ref_shard, items, remote, up, imp_slot, id_space: int,
                local_vals, offset: int):
    """Per-reference index into [local | halo]: local_vals where local,
    offset + the rank's import slot where remote."""
    if not up.size:
        return np.asarray(local_vals, np.int64)
    pair = ref_shard.astype(np.int64) * id_space + items
    pos = np.clip(np.searchsorted(up, pair), 0, len(up) - 1)
    return np.where(remote, offset + imp_slot[pos], local_vals)


def _shard_scatter_plan(owner, n_shards: int, min_cap: int = 0):
    """Row/col scatter coordinates that place each element into its
    rank's padded row, keeping the original order within a rank. Returns
    (row, col, order, cap)."""
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_shards)
    cap = max(int(counts.max()) if len(owner) else 0, min_cap)
    starts = np.concatenate([[0], np.cumsum(counts)])
    row = owner[order]
    col = np.arange(len(order)) - starts[row]
    return row, col, order, cap


def build_halo_partition(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                         num_nodes: int, n_shards: int, to_device: bool = True,
                         device: str | torch.device | None = None
                         ) -> HaloPartition:
    """Contiguous-range node partition; edges owned by their source's
    rank. A vectorised host build (numpy sort/unique/bincount group-bys,
    O(E log E)), as million-edge graphs need. to_device=False keeps the
    tables as numpy arrays; else they go to ``device`` (default cuda)."""
    if num_nodes % n_shards:
        raise ValueError(f"num_nodes {num_nodes} % n_shards {n_shards} != 0")
    vl = num_nodes // n_shards
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w)
    S = n_shards
    owner_src = src // vl
    remote = owner_src != dst // vl

    export_idx, import_flat, hi, up, imp_slot = _halo_exchange_tables(
        owner_src[remote], dst[remote],
        item_owner=lambda n: n // vl, item_local=lambda n: n - (n // vl) * vl,
        n_shards=S, id_space=num_nodes)
    dst_local_g = _remap_refs(owner_src, dst, remote, up, imp_slot,
                              num_nodes, dst - owner_src * vl, vl)

    # scatter edges into padded (S, el) rows, original order per rank
    row, col, order, el = _shard_scatter_plan(owner_src, S)
    src_pad = np.zeros((S, el), np.int32)
    dst_pad = np.zeros((S, el), np.int32)
    w_pad = np.zeros((S, el), np.float32)
    src_pad[row, col] = (src[order] - row * vl).astype(np.int32)
    dst_pad[row, col] = dst_local_g[order].astype(np.int32)
    w_pad[row, col] = w[order].astype(np.float32)

    if to_device:
        dev = resolve_device(device)

        def conv(a):
            return torch.from_numpy(a).to(dev)
    else:
        def conv(a):
            return a
    return HaloPartition(
        src_local=conv(src_pad), dst_local=conv(dst_pad), w=conv(w_pad),
        export_idx=conv(export_idx), import_flat=conv(import_flat),
        nodes_per_shard=vl, n_imports=hi)


def _check_ranks(mesh: spmd.RankGrid, n_shards: int) -> None:
    if mesh.shape["edge"] != n_shards:
        raise ValueError(f"{n_shards} halo ranks, the grid's edge axis has "
                         f"{mesh.shape['edge']}")


def _rank_offsets(table: torch.Tensor, step: int) -> torch.Tensor:
    """A (S, n) table of rank-local indices as flat indices: rank r's
    moved by r * step."""
    S = table.shape[0]
    rank = torch.arange(S, device=table.device, dtype=table.dtype)[:, None]
    return (table + rank * step).reshape(-1)


def _local_rows(mesh: spmd.RankGrid, t):
    """A tensor's (or a dict of tensors') rows of this process's ranks
    along "edge": all of them in one process."""
    if "edge" not in mesh.groups:
        return t
    lo = mesh.axis_index("edge")
    hi = lo + mesh.local["edge"]
    if isinstance(t, dict):
        return {k: v[lo:hi] for k, v in t.items()}
    return t[lo:hi]


def _extend(x: torch.Tensor, export_flat: torch.Tensor,
            import_flat: torch.Tensor, n_local: int,
            axis: str = "edge") -> torch.Tensor:
    """[x_local | imported halo rows] of this process's S ranks,
    flattened: x is the ranks' (S * n_local, F) rows laid end to end; the
    ranks' export buffers (export_flat, into x), gathered over the
    processes along ``axis`` where it spans them (spmd.all_gather), make
    the (S_all * Hx, F) stack that all_gather delivers to each rank, and
    import_flat (S, Hi) picks each rank's halo from it. Returns
    (S * (n_local + Hi), F)."""
    S, hi = import_flat.shape
    gathered = spmd.all_gather(sparse.gather(x, export_flat), axis)
    halo = sparse.gather(gathered, import_flat.reshape(-1))
    F = x.shape[-1]
    return torch.cat([x.reshape(S, n_local, F), halo.reshape(S, hi, F)],
                     1).reshape(-1, F)


def halo_partitioned_spmm(mesh: spmd.RankGrid, part: HaloPartition):
    """Returns f(x_stacked (S, Vl, F)) -> the same shape: the full-graph
    SpMM with only halo rows exchanged, the S ranks being the grid's
    "edge" axis. Over processes x_stacked and the result are this
    process's ranks' rows (the part's tables stay global)."""
    _check_ranks(mesh, part.n_shards)
    vl = part.nodes_per_shard
    import_flat = _local_rows(mesh, part.import_flat)
    S, hi = import_flat.shape
    export_flat = _rank_offsets(_local_rows(mesh, part.export_idx), vl)
    dst = _rank_offsets(_local_rows(mesh, part.dst_local), vl + hi)
    src = _rank_offsets(_local_rows(mesh, part.src_local), vl)
    w = _local_rows(mesh, part.w).reshape(-1)

    def apply(x_stacked):
        F = x_stacked.shape[-1]
        x = x_stacked.reshape(S * vl, F)
        with mesh:
            xx = _extend(x, export_flat, import_flat, vl)
        out = sparse.segment_sum(w[:, None] * sparse.gather(xx, dst), src,
                                 S * vl)
        return out.reshape(S, vl, F)

    return apply


# ---------------------------------------------------------------------------
# Full packed GNN / LGGNN under halo partitioning.
#
# Every line-graph operator reduces to two halo primitives once edges are
# owned by their SOURCE node's rank:
#   * node halo: rows of a rank's (Vl, F) node array referenced by local
#     edges' remote dst (feeds SpMM, Pm^T/Pd^T and the NB operator's
#     y[dst] term);
#   * edge halo: features of the REVERSE edges of cut edges, which live on
#     the dst node's rank (feeds the NB correction term and turns Pm/Pd
#     into purely local scatters via
#     sum_{e: dst=v} f(e) == sum_{e': src=v} f(rev(e')): reverse pairs
#     exchange roles, so the dst-sum over remote-owned edges becomes a
#     src-sum over local edges of halo-imported reverse features).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HaloLGBundle:
    """Stacked (leading axis = rank) arrays for a packed GNN/LGGNN under
    halo partitioning, plus the per-graph arrays every rank shares."""

    arrays: dict  # stacked per-rank arrays
    y: torch.Tensor  # (B,)
    gmask: torch.Tensor  # (B,)
    n_graphs: int
    nodes_per_shard: int
    halo_sizes: dict  # {"node_export": Hx, "node_import": Hi,
    #                    "edge_export": Gx, "edge_import": Gi}

    @property
    def n_shards(self) -> int:
        return self.arrays["x"].shape[0]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def build_halo_lg_bundle(pb: PackedGraphBatch, n_shards: int,
                         device: str | torch.device | None = None
                         ) -> HaloLGBundle:
    """Partitions a PackedGraphBatch (typically one giant graph) into
    n_shards contiguous node ranges with full halo tables for every
    line-graph operator; requires num_node_slots % n_shards == 0. The
    vectorised host build of build_halo_partition; the arrays go to
    ``device`` (default cuda) and equal the JAX package's."""
    V = pb.num_node_slots
    if V % n_shards:
        raise ValueError(f"node slots {V} % n_shards {n_shards} != 0")
    dev = resolve_device(device)
    vl = V // n_shards
    S = n_shards
    src = _np(pb.src).astype(np.int64)
    dst = _np(pb.dst).astype(np.int64)
    w = _np(pb.w).astype(np.float32)
    rev = _np(pb.rev).astype(np.int64)
    emask = _np(pb.edge_mask).astype(np.float32)
    E = len(src)
    owner = src // vl

    # edges to ranks, original order kept; the global slot map
    row, col, order, el = _shard_scatter_plan(owner, S, min_cap=1)
    slot_of_edge = np.empty(E, np.int64)
    slot_of_edge[order] = col

    # node halo: each rank's unique remote dst nodes
    n_remote = dst // vl != owner
    nexport_idx, nimport_flat, hi, n_up, n_slot = _halo_exchange_tables(
        owner[n_remote], dst[n_remote],
        item_owner=lambda n: n // vl, item_local=lambda n: n - (n // vl) * vl,
        n_shards=S, id_space=V)
    hx = nexport_idx.shape[1]

    # edge halo: each rank's unique remote REVERSE edges of local edges
    r_owner = owner[rev]
    e_remote = r_owner != owner
    eexport_idx, eimport_flat, gi, e_up, e_slot = _halo_exchange_tables(
        owner[e_remote], rev[e_remote],
        item_owner=lambda ge: owner[ge], item_local=lambda ge: slot_of_edge[ge],
        n_shards=S, id_space=max(E, 1))
    gx = eexport_idx.shape[1]

    # per-edge remaps into [local | halo] coordinates
    d_ext = _remap_refs(owner, dst, n_remote, n_up, n_slot, V,
                        dst - owner * vl, vl)
    r_ext = _remap_refs(owner, rev, e_remote, e_up, e_slot, max(E, 1),
                        slot_of_edge[rev], el)

    # per-rank local edge arrays (scatter, original order per rank)
    src_local = np.zeros((S, el), np.int32)
    dst_ext = np.zeros((S, el), np.int32)
    w_pad = np.zeros((S, el), np.float32)
    w_rev = np.zeros((S, el), np.float32)
    rev_ext = np.tile(np.arange(el, dtype=np.int32), (S, 1))  # self at padding
    em_pad = np.zeros((S, el), np.float32)
    src_local[row, col] = (src[order] - row * vl).astype(np.int32)
    dst_ext[row, col] = d_ext[order].astype(np.int32)
    w_pad[row, col] = w[order]
    w_rev[row, col] = w[rev[order]]
    em_pad[row, col] = emask[order]
    rev_ext[row, col] = r_ext[order].astype(np.int32)

    x = _np(pb.x)
    arrays = {
        "x": x.reshape(S, vl, -1),
        "node_gid": _np(pb.node_gid).reshape(S, vl),
        "node_mask": _np(pb.node_mask).astype(np.float32).reshape(S, vl),
        "src_local": src_local,
        "dst_ext": dst_ext,
        "w": w_pad,
        "w_rev": w_rev,
        "rev_ext": rev_ext,
        "edge_mask": em_pad,
        "nexport_idx": nexport_idx,
        "nimport_flat": nimport_flat,
        "eexport_idx": eexport_idx,
        "eimport_flat": eimport_flat,
    }
    gmask = (_np(pb.gmask) if pb.gmask is not None
             else np.ones(_np(pb.y).shape, np.float32))
    return HaloLGBundle(
        arrays={k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in arrays.items()},
        y=torch.from_numpy(_np(pb.y)).to(dev),
        gmask=torch.from_numpy(gmask).to(dev),
        n_graphs=pb.n_graphs,
        nodes_per_shard=vl,
        halo_sizes={"node_export": hx, "node_import": hi,
                    "edge_export": gx, "edge_import": gi})


class HaloLocalOps:
    """The SparsePackedOps interface (graph_op, lg_graph_op, pm, pd,
    pm_t, pd_t, nb_degrees) over the S halo ranks of a bundle's stacked
    arrays ``t``, run as one flattened batch (ranks laid end to end,
    rank-major): all ranks in one process, or this process's rows of them
    when ``axis`` spans processes (build and call it inside ``with
    grid:``, as halo_packed_loss does). Aggregation outputs are rank-local
    by edge ownership; remote reads go through the two halo exchanges
    (_extend: the gathered export buffers, O(S H F), in place of the
    all-reduce path's O(V F) a apply). comm_log, when given, records the
    feature width of every exchange, for exact volume accounting
    (halo_comm_bytes).

    The exchanges are memoised by identity: pm and pd (and pm_t and pd_t)
    read the same input a layer, and one exchange serves both, so
    comm_log counts exactly what JAX's compiled program sends. The cache
    holds a reference to each key tensor, so ids cannot be recycled; the
    ops object lives for one forward."""

    def __init__(self, t: dict, J: int, axis: str = "edge",
                 comm_log: dict | None = None):
        spmd.mesh_axes(axis)
        self.t, self.J, self.axis, self.comm_log = t, J, axis, comm_log
        self._ext_cache: dict = {}
        S, vl = t["x"].shape[:2]
        el = t["src_local"].shape[1]
        self.S, self.vl, self.el = S, vl, el
        self.V = S * vl
        hi, gi = t["nimport_flat"].shape[1], t["eimport_flat"].shape[1]
        self.src = _rank_offsets(t["src_local"], vl)
        self.dst = _rank_offsets(t["dst_ext"], vl + hi)
        self.rev = _rank_offsets(t["rev_ext"], el + gi)
        self._nexp = _rank_offsets(t["nexport_idx"], vl)
        self._eexp = _rank_offsets(t["eexport_idx"], el)
        self.w = t["w"].reshape(-1)
        self.w_rev = t["w_rev"].reshape(-1)
        self.edge_mask = t["edge_mask"].reshape(-1)
        self.deg = sparse.segment_sum(self.w, self.src, self.V)
        deg_ext = self._node_ext(self.deg[:, None])
        self.dl = ((sparse.gather(deg_ext, self.dst)[:, 0] - self.w_rev)
                   * self.edge_mask)

    def _log(self, kind: str, width: int) -> None:
        if self.comm_log is not None:
            self.comm_log[kind].append(int(width))

    def _cached(self, kind: str, x, compute):
        key = (kind, id(x))
        hit = self._ext_cache.get(key)
        if hit is not None and hit[0] is x:
            return hit[1]
        out = compute()
        self._ext_cache[key] = (x, out)
        return out

    def _node_ext(self, x):
        """[x_local | halo rows imported from other ranks] of every rank:
        (S * (Vl + Hi), F)."""

        def compute():
            self._log("node_halo", x.shape[-1])
            return _extend(x, self._nexp, self.t["nimport_flat"], self.vl,
                           self.axis)

        return self._cached("node", x, compute)

    def _edge_ext(self, xl):
        """[xl_local | reverse-edge halo] of every rank: (S * (El + Gi), F)."""

        def compute():
            self._log("edge_halo", xl.shape[-1])
            return _extend(xl, self._eexp, self.t["eimport_flat"], self.el,
                           self.axis)

        return self._cached("edge", xl, compute)

    def _spmm(self, x):
        xx = self._node_ext(x)
        return sparse.segment_sum(
            self.w[:, None] * sparse.gather(xx, self.dst), self.src, self.V)

    def graph_op(self, x):
        return sparse.power_blocks(x, self.deg, self._spmm, self.J)

    def _nb(self, xl):
        y = sparse.segment_sum(self.w[:, None] * xl, self.src, self.V)
        yy = self._node_ext(y)
        xle = self._edge_ext(xl)
        out = (sparse.gather(yy, self.dst)
               - self.w_rev[:, None] * sparse.gather(xle, self.rev))
        return out * self.edge_mask[:, None]

    def lg_graph_op(self, xl):
        return sparse.power_blocks(xl, self.dl, self._nb, self.J)

    def _pm_pd(self, xl, signed: bool):
        xrev = sparse.gather(self._edge_ext(xl), self.rev)
        contrib = (xl - xrev) if signed else (xl + xrev)
        return sparse.segment_sum(contrib * self.edge_mask[:, None], self.src,
                                  self.V)

    def pm(self, xl):
        return self._pm_pd(xl, signed=False)

    def pd(self, xl):
        return self._pm_pd(xl, signed=True)

    def _pm_pd_t(self, x, signed: bool):
        a = sparse.gather(x, self.src)
        b = sparse.gather(self._node_ext(x), self.dst)
        out = (a - b) if signed else (a + b)
        return out * self.edge_mask[:, None]

    def pm_t(self, x):
        return self._pm_pd_t(x, signed=False)

    def pd_t(self, x):
        return self._pm_pd_t(x, signed=True)

    def nb_degrees(self):
        return self.dl


def halo_packed_loss(model, mesh: spmd.RankGrid, bundle: HaloLGBundle,
                     kind: str = "regression", mean: float = 0.0,
                     std: float = 1.0, comm_log: dict | None = None):
    """loss_fn(bundle_arrays=None) -> the masked training loss of a packed
    model (PackedLGGNN or PackedGNN, built with bn_axis="edge") over a
    halo-partitioned bundle, the S ranks being the grid's "edge" axis;
    differentiable with respect to the model's parameters, the forward in
    train mode (updating the BN running statistics). The model takes the
    HaloLocalOps bundle through ops= (PackedGNN uses its graph_op only).
    Each rank's readout is a partial sum over its node range, summed over
    the ranks by spmd.psum (JAX's psum of the partials): in one process
    the ranks run as one flattened batch, so the readout and BN's
    statistics are already whole; over processes each runs its own rows
    of the bundle (all of it given, global, to every process), and the
    psums cross them. The step then backpropagates through
    spmd.backward(loss, mesh, params)."""
    _check_ranks(mesh, bundle.n_shards)

    def loss_fn(bundle_arrays: dict | None = None) -> torch.Tensor:
        t = _local_rows(mesh, bundle_arrays if bundle_arrays is not None
                        else bundle.arrays)
        S, vl = t["x"].shape[:2]
        model.train()
        with mesh:
            ops = HaloLocalOps(t, J=model.J, comm_log=comm_log)
            pb = PackedGraphBatch(
                x=t["x"].reshape(S * vl, -1),
                node_gid=t["node_gid"].reshape(-1),
                node_mask=t["node_mask"].reshape(-1), src=ops.src,
                dst=ops.dst, w=ops.w, rev=ops.rev,
                edge_gid=torch.zeros_like(ops.src), edge_mask=ops.edge_mask,
                y=bundle.y, gmask=bundle.gmask, n_graphs=bundle.n_graphs)
            out = spmd.psum(model(pb, ops=ops), "edge")
        per = spmd.per_graph_loss(out, bundle.y, kind, mean, std)
        return (per * bundle.gmask).sum() / bundle.gmask.sum().clamp_min(1.0)

    return loss_fn


def halo_comm_bytes(comm_log: dict, bundle: HaloLGBundle, n_shards: int,
                    dtype_bytes: int = 4) -> dict:
    """The halo exchanges' volume of one forward (fill comm_log by running
    a forward through halo_packed_loss). An all_gather of a (H, F) export
    buffer delivers (S-1) remote buffers to each rank: (S-1) H F
    dtype_bytes received a rank an exchange. The backward transposes each
    all_gather into a reduce_scatter of equal volume, doubling the
    training step's total."""
    hx = bundle.halo_sizes["node_export"]
    gx = bundle.halo_sizes["edge_export"]
    node = sum((n_shards - 1) * hx * f * dtype_bytes
               for f in comm_log.get("node_halo", []))
    edge = sum((n_shards - 1) * gx * f * dtype_bytes
               for f in comm_log.get("edge_halo", []))
    return {
        "n_node_halo_fwd": len(comm_log.get("node_halo", [])),
        "n_edge_halo_fwd": len(comm_log.get("edge_halo", [])),
        "forward_bytes_per_chip": node + edge,
        "train_step_bytes_per_chip": 2 * (node + edge),
        "node_halo_rows": hx,
        "edge_halo_rows": gx,
    }


def new_comm_log() -> dict:
    return {"node_halo": [], "edge_halo": []}
