"""Dense-block batched graph operators (counterpart of the node side of
hgnn2_tpu/ops/dense.py).

The hot op, graph_op, applies the operator stack [I, diag(d), A, A^2,
A^4, ...] to a padded (B, N, F) batch as one batched matmul against the
(B, J, N, N) adjacency powers plus two elementwise blocks. The JAX
package computes it outside any Pallas kernel, and here it stays a
PyTorch matmul. The line-graph (edge) operators come with the line-graph
slice.
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
