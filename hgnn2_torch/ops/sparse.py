"""Packed-sparse graph operators over flat (node, edge) arrays
(counterpart of hgnn2_tpu/ops/sparse.py).

Every segment sum is ``index_add_`` into a zero block, as the JAX package
leaves XLA's segment_sum outside any Pallas kernel. On CUDA, index_add_
accumulates with atomics, so the sum order (and the last bits) can change
from run to run. Index arrays are int32, as the batches hold them.
Every gather is ``gather`` (index_select), whose gradient is an
index_add_ as well.
"""

from __future__ import annotations

import torch


def segment_sum(vals: torch.Tensor, idx: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of vals[e] over e with idx[e] == s; vals (E, F) ->
    (num_segments, F)."""
    out = vals.new_zeros((num_segments,) + vals.shape[1:])
    return out.index_add_(0, idx, vals)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the first axis. Its gradient is index_add_, one
    atomic an element on CUDA. x[idx] with a tensor index would have
    index_put_'s gradient instead, which sorts the indices and adds each
    run of equal indices serially in one warp: every padded edge of a
    packed batch points at node V - 1, so a batch padded to its epoch's
    uniform capacity holds runs of thousands."""
    return x.index_select(0, idx)


def spmm(src, dst, w, x: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """(A @ X)[i] = sum_{e: src(e)=i} w(e) X[dst(e)]; x (V, F) -> (V, F).
    Padded edges carry w = 0 so they contribute nothing."""
    return segment_sum(w[:, None] * gather(x, dst), src, num_nodes)


def degrees(src, w, num_nodes: int) -> torch.Tensor:
    """Weighted degree d[i] = sum_{e: src(e)=i} w(e)."""
    return segment_sum(w, src, num_nodes)


def power_blocks(x, scale, apply, J: int) -> torch.Tensor:
    """[x | scale*x | op x | op^2 x | op^4 x ...]: op^(2^j) by repeated
    application, never materialising powers."""
    blocks = [x, scale[:, None] * x]
    cur, applied = x, 0
    for j in range(J):
        while applied < 2 ** j:
            cur = apply(cur)
            applied += 1
        blocks.append(cur)
    return torch.cat(blocks, dim=1)


def graph_op(src, dst, w, x: torch.Tensor, num_nodes: int, J: int,
             deg: torch.Tensor | None = None) -> torch.Tensor:
    """Packed multi-operator apply [X | d*X | A X | A^2 X | ...] ->
    (V, (J+2)F)."""
    if deg is None:
        deg = degrees(src, w, num_nodes)
    return power_blocks(x, deg, lambda c: spmm(src, dst, w, c, num_nodes), J)


def nb_apply(src, dst, w, rev, edge_mask, xl: torch.Tensor,
             num_nodes: int) -> torch.Tensor:
    """Non-backtracking operator: (AL @ XL)[e] = Y[dst(e)] - w(rev(e))
    XL[rev(e)] with Y = segment_sum(w XL, src); xl (C, F) -> (C, F)."""
    y = segment_sum(w[:, None] * xl, src, num_nodes)
    out = gather(y, dst) - gather(w, rev)[:, None] * gather(xl, rev)
    return out * edge_mask[:, None]


def nb_degrees(src, dst, w, rev, edge_mask, num_nodes: int) -> torch.Tensor:
    ones = w.new_ones(w.shape + (1,))
    return nb_apply(src, dst, w, rev, edge_mask, ones, num_nodes)[:, 0]


def lg_graph_op(src, dst, w, rev, edge_mask, xl: torch.Tensor,
                num_nodes: int, J: int,
                dl: torch.Tensor | None = None) -> torch.Tensor:
    """Packed line-graph multi-operator apply -> (C, (J+2)F)."""
    if dl is None:
        dl = nb_degrees(src, dst, w, rev, edge_mask, num_nodes)
    return power_blocks(
        xl, dl, lambda c: nb_apply(src, dst, w, rev, edge_mask, c, num_nodes),
        J)


def incidence_apply(src, dst, edge_mask, xl: torch.Tensor, num_nodes: int,
                    signed: bool) -> torch.Tensor:
    """Pm @ XL (signed=False) or Pd @ XL (signed=True): edge features
    (C, F) -> node features (V, F)."""
    xm = xl * edge_mask[:, None]
    a = segment_sum(xm, src, num_nodes)
    b = segment_sum(xm, dst, num_nodes)
    return a - b if signed else a + b


def incidence_t_apply(src, dst, edge_mask, x: torch.Tensor,
                      signed: bool) -> torch.Tensor:
    """Pm^T @ X / Pd^T @ X: node features (V, F) -> edge features (C, F)."""
    a, b = gather(x, src), gather(x, dst)
    out = a - b if signed else a + b
    return out * edge_mask[:, None]


def graph_readout(x: torch.Tensor, gid: torch.Tensor,
                  n_graphs: int) -> torch.Tensor:
    """Per-graph sum readout: (V, F) + (V,) -> (B, F); padding rows carry
    gid = n_graphs and land in an extra row that is dropped."""
    return segment_sum(x, gid, n_graphs + 1)[:n_graphs]
