"""Dense-block batched graph operators (counterpart of
hgnn2_tpu/ops/dense.py).

The hot op, graph_op, applies the operator stack [I, diag(d), A, A^2,
A^4, ...] to a padded (B, N, F) batch as one batched matmul against the
(B, J, N, N) adjacency powers plus two elementwise blocks. The JAX
package computes it outside any Pallas kernel, and here it stays a
PyTorch matmul.

The line-graph (edge) operators never build the M x M non-backtracking
matrix: with directed edges e = (u -> v) and rev(e) the opposite edge,

    (AL @ XL)[e] = Y[dst(e)] - w(rev(e)) * XL[rev(e)],
    Y[n] = sum_{e': src(e') = n} w(e') XL[e']

which is two batched matmuls against the {0, 1} scatter matrices built
from src and dst, and a gather through rev. Like the JAX package's, the
gather reads edge 0 at padded edges (rev = 0 there), so padded rows of
the result are not zero; the masked scatter matrices and batch norm keep
them out of real outputs.

These one-hot products are the counterparts of the JAX package's, held
to them in the tests, and the yardstick of the exchange the model runs:
nn/bundles.py:DenseBundle takes the index form of ops/lg_exchange.py
(gathers and segment sums over src, dst and rev, the same sums in
another order) on every device, and builds no scatter matrix.
"""

from __future__ import annotations

import torch


def _acc_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Einsum with f32 accumulation, output in b's (compute) dtype.

    Inputs of different dtypes meet in their promoted dtype. A bf16 matmul
    on CUDA accumulates in f32 and rounds its output once, as the JAX
    package's preferred_element_type=f32 dot does; on the CPU bf16 inputs
    are upcast first, as JAX does there (same math, other rounding)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if dt == torch.bfloat16 and a.device.type == "cpu":
        dt = torch.float32
    return torch.einsum(spec, a.to(dt), b.to(dt)).to(b.dtype)


def adjacency_powers(adj: torch.Tensor, J: int) -> torch.Tensor:
    """(B, N, N) -> (B, J, N, N) stack [A, A^2, A^4, ...] by repeated
    squaring in f32 (slot j + 2 of the operator stack is A^(2^(j-1))).
    At J = 1 it is a view of adj, not a copy."""
    if J == 1:
        return adj[:, None]
    powers = [adj]
    cur = adj
    for _ in range(1, J):
        cur = torch.bmm(cur, cur)
        powers.append(cur)
    return torch.stack(powers, dim=1)


def degrees(adj: torch.Tensor) -> torch.Tensor:
    """(B, N, N) -> (B, N) weighted degrees."""
    return adj.sum(dim=2)


def graph_op(
    adj_powers: torch.Tensor,
    deg: torch.Tensor,
    x: torch.Tensor,
    node_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """[I, diag(d), A, A^2, ...] applied to X.

    adj_powers (B, J, N, N), deg (B, N), x (B, N, F) -> (B, N, (J+2)*F),
    feature blocks ordered [X | d*X | A X | A^2 X ...], block-major with
    F inside. node_mask zeroes padded rows of the identity block (the
    padded identity operator is diag(mask)), which matters when padded
    rows of x are nonzero."""
    B, N, F = x.shape
    ident = x if node_mask is None else x * node_mask.to(x.dtype)[:, :, None]
    ax = _acc_einsum("bjnm,bmf->bnjf", adj_powers, x)
    blocks = torch.cat(
        [ident[:, :, None, :], (deg[:, :, None] * x)[:, :, None, :], ax], dim=2)
    return blocks.reshape(B, N, -1)


def graph_op_materialized(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Applies a dense (B, N, N, J) operator stack: the oracle for
    graph_op in the tests."""
    B, N, _, J = W.shape
    out = torch.einsum("bnmj,bmf->bnjf", W, x)
    return out.reshape(B, N, -1)


# Line-graph operators from (src, dst, w, rev) edge arrays.


def edge_scatter_matrices(src: torch.Tensor, dst: torch.Tensor,
                          edge_mask: torch.Tensor, n_nodes: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-hot scatter matrices S_src, S_dst of shape (B, N, M), float32:
    S_src[b, n, e] = 1 iff src[b, e] == n and edge e is real."""
    n_ids = torch.arange(n_nodes, dtype=src.dtype, device=src.device)[None, :, None]
    emask = edge_mask[:, None, :]
    s_src = (src[:, None, :] == n_ids).float() * emask
    s_dst = (dst[:, None, :] == n_ids).float() * emask
    return s_src, s_dst


def edge_to_node(s: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
    """(B, N, M) x (B, M, F) -> (B, N, F) scatter-sum (f32 accumulation,
    output in the compute dtype)."""
    return _acc_einsum("bnm,bmf->bnf", s, xl)


def node_to_edge(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, N, M) x (B, N, F) -> (B, M, F) gather (f32 accumulation, output
    in the compute dtype)."""
    return _acc_einsum("bnm,bnf->bmf", s, x)


def incidence_apply(s_src, s_dst, xl: torch.Tensor, signed: bool) -> torch.Tensor:
    """Pm @ XL (signed=False) or Pd @ XL (signed=True): (B, M, F) -> (B, N, F).
    Pm[u, e] = Pm[v, e] = 1 and Pd[u, e] = +1, Pd[v, e] = -1 for
    e = (u -> v)."""
    a = edge_to_node(s_src, xl)
    b = edge_to_node(s_dst, xl)
    return a - b if signed else a + b


def incidence_t_apply(s_src, s_dst, x: torch.Tensor, signed: bool) -> torch.Tensor:
    """Pm^T @ X or Pd^T @ X: (B, N, F) -> (B, M, F)."""
    a = node_to_edge(s_src, x)
    b = node_to_edge(s_dst, x)
    return a - b if signed else a + b


def nb_apply(s_src: torch.Tensor, s_dst: torch.Tensor, w: torch.Tensor,
             rev: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
    """Non-backtracking operator apply (AL @ XL) without building AL.
    w (B, M), rev (B, M) int64 (other integer dtypes are converted),
    xl (B, M, F) -> (B, M, F)."""
    rev = rev.long()
    y = edge_to_node(s_src, w[:, :, None] * xl)  # (B, N, F)
    cont = node_to_edge(s_dst, y)  # Y[dst(e)]
    w_rev = torch.gather(w, 1, rev)
    xl_rev = torch.gather(xl, 1, rev[:, :, None].expand(-1, -1, xl.shape[2]))
    return cont - w_rev[:, :, None] * xl_rev


def nb_degrees(s_src, s_dst, w: torch.Tensor, rev: torch.Tensor) -> torch.Tensor:
    """NB line-graph degrees dl[e] = sum_e' AL[e, e'], (B, M)."""
    ones = torch.ones(w.shape + (1,), dtype=w.dtype, device=w.device)
    return nb_apply(s_src, s_dst, w, rev, ones)[..., 0]


def lg_graph_op(s_src, s_dst, w, rev, dl: torch.Tensor, xl: torch.Tensor,
                J: int, edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Line-graph multi-operator apply [I, diag(dL), AL, AL^2, AL^4, ...]
    to XL: (B, M, F) -> (B, M, (J+2)*F), blocks in that order. Slot j + 2
    is AL^(2^(j-1)), applied as repeated nb_apply, never built.
    edge_mask zeroes padded rows of the identity block."""
    ident = xl if edge_mask is None else xl * edge_mask.to(xl.dtype)[:, :, None]
    blocks = [ident, dl.to(xl.dtype)[:, :, None] * xl]
    cur, applied = xl, 0
    for j in range(J):
        while applied < 2 ** j:
            cur = nb_apply(s_src, s_dst, w, rev, cur)
            applied += 1
        blocks.append(cur)
    return torch.cat(blocks, dim=2)
