"""Operator bundles (counterpart of hgnn2_tpu/nn/bundles.py): what a model
applies to its features for one batch.

  * DenseBundle: the production path. It holds a DenseGraphBatch's
    adjacency powers, degrees and node mask and, for the line-graph GNN,
    the edge arrays and NB degrees. The power operators are a batched
    matmul (ops/dense.py). The line-graph exchange runs in index form on
    CUDA in float32 (ops/lg_exchange.py's kernels: gathers and segment
    sums over src, dst and rev); elsewhere it is the composition of
    products with one-hot scatter matrices and a gather (ops/dense.py).
    The model builds it once per forward.
  * FusedLGBundle: each line-graph update's whole operator input as ONE
    batched matmul against a (B, J+4, rows, N+M) tensor built per batch
    (GNNLineGraph(fused_ops=True)); the same math.
  * MaterializedBundle: explicit dense operator stacks and incidence
    matrices (the original implementation's layout, hgnn2_torch.operators'
    dense builders); the oracle of the production path in the tests.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from hgnn2_torch import profiling
from hgnn2_torch.ops import dense as D
from hgnn2_torch.ops import lg_exchange as X

EXCHANGE = "hgnn2.lg.exchange"


@dataclasses.dataclass
class DenseBundle:
    """Operator bundle computed from a dense batch's adjacency and edge
    arrays. The line-graph exchange takes the index-form kernels where
    ``src`` is set (CUDA, float32), else the one-hot scatter matrices
    ``s_src`` and ``s_dst``."""

    adj_powers: torch.Tensor  # (B, J, N, N)
    deg: torch.Tensor  # (B, N)
    J: int
    node_mask: torch.Tensor | None = None  # (B, N)
    # line-graph pieces (None for power-GNN batches)
    src: torch.Tensor | None = None  # (B, M) int32, index form only
    dst: torch.Tensor | None = None
    s_src: torch.Tensor | None = None  # (B, N, M), composition only
    s_dst: torch.Tensor | None = None
    w: torch.Tensor | None = None  # (B, M)
    rev: torch.Tensor | None = None  # (B, M): int32 index form, int64 composition
    dl: torch.Tensor | None = None  # (B, M) NB degrees
    edge_mask: torch.Tensor | None = None

    @classmethod
    def from_batch(cls, batch, J: int, with_line_graph: bool = False,
                   dtype: torch.dtype | None = None,
                   one_hot: bool = False) -> "DenseBundle":
        """dtype casts the operator tensors (bf16 compute); the powers,
        degrees and NB degrees are computed in f32 first, then cast. On
        CUDA in float32 the line graph keeps the batch's int32 src, dst
        and rev for the index-form kernels, and dl is one kernel; else,
        or with one_hot (FusedLGBundle's operand), it builds the one-hot
        scatter matrices and the reverse indices become int64, once per
        batch. The line-graph part runs in the host span
        hgnn2.lg.bundle."""
        adj_powers = D.adjacency_powers(batch.adj, J)
        deg = D.degrees(batch.adj)
        if dtype is not None:
            adj_powers, deg = adj_powers.to(dtype), deg.to(dtype)
        if not (with_line_graph and batch.has_line_graph):
            return cls(adj_powers=adj_powers, deg=deg, J=J,
                       node_mask=batch.node_mask)
        with profiling.span("hgnn2.lg.bundle"):
            w, emask, n_nodes = batch.lg_w, batch.edge_mask, batch.x.shape[1]
            if (not one_hot and dtype in (None, w.dtype)
                    and X.use_kernel(w.device, w.dtype)):
                src, dst, rev = batch.lg_src, batch.lg_dst, batch.lg_rev
                return cls(adj_powers=adj_powers, deg=deg, J=J,
                           node_mask=batch.node_mask, src=src, dst=dst, w=w,
                           rev=rev, edge_mask=emask,
                           dl=X.nb_degrees(src, dst, rev, emask, w, n_nodes))
            s_src, s_dst = D.edge_scatter_matrices(
                batch.lg_src, batch.lg_dst, emask, n_nodes)
            rev = batch.lg_rev.long()
            dl = D.nb_degrees(s_src, s_dst, w, rev) * emask
            if dtype is not None:
                s_src, s_dst = s_src.to(dtype), s_dst.to(dtype)
                dl, w = dl.to(dtype), w.to(dtype)
        return cls(adj_powers=adj_powers, deg=deg, J=J,
                   node_mask=batch.node_mask, s_src=s_src, s_dst=s_dst, w=w,
                   rev=rev, dl=dl, edge_mask=emask)

    @property
    def has_line_graph(self) -> bool:
        return self.w is not None

    @property
    def index_form(self) -> bool:
        """Whether the exchange takes the index-form kernels."""
        return self.src is not None

    def graph_op(self, x: torch.Tensor) -> torch.Tensor:
        return D.graph_op(self.adj_powers, self.deg, x, self.node_mask)

    # the line-graph exchange, each apply in the host span hgnn2.lg.exchange

    def lg_graph_op(self, xl: torch.Tensor) -> torch.Tensor:
        with profiling.span(EXCHANGE):
            if self.index_form:
                return X.lg_graph_op(self.src, self.dst, self.rev,
                                     self.edge_mask, self.w, self.dl, xl,
                                     self.J, self.deg.shape[1])
            return D.lg_graph_op(self.s_src, self.s_dst, self.w, self.rev,
                                 self.dl, xl, self.J, self.edge_mask)

    def pm_pd(self, xl: torch.Tensor) -> torch.Tensor:
        """[Pm xl | Pd xl]: (B, M, F) -> (B, N, 2F)."""
        with profiling.span(EXCHANGE):
            if self.index_form:
                return X.pm_pd(self.src, self.dst, self.edge_mask, xl,
                               self.deg.shape[1])
            return torch.cat([
                D.incidence_apply(self.s_src, self.s_dst, xl, signed=False),
                D.incidence_apply(self.s_src, self.s_dst, xl, signed=True)],
                dim=-1)

    def pm_pd_t(self, x: torch.Tensor) -> torch.Tensor:
        """[Pm^T x | Pd^T x]: (B, N, F) -> (B, M, 2F)."""
        with profiling.span(EXCHANGE):
            if self.index_form:
                return X.pm_pd_t(self.src, self.dst, self.edge_mask, x)
            return torch.cat([
                D.incidence_t_apply(self.s_src, self.s_dst, x, signed=False),
                D.incidence_t_apply(self.s_src, self.s_dst, x, signed=True)],
                dim=-1)

    def edge_features(self) -> torch.Tensor:
        """Initial edge state XL = the NB line-graph degrees, (B, M, 1)."""
        return self.dl[:, :, None]


@dataclasses.dataclass
class FusedLGBundle:
    """Combined-operator bundle: each LGLayer update's whole operator input
    ([graph_op X | Pm XL | Pd XL] node-side, [lg_graph_op XL | Pm^T X |
    Pd^T X] edge-side) is ONE batched matmul against a (B, J+4, rows,
    N+M) tensor built per batch, with the NB operator as a dense (B, M, M)
    block. Block order matches the unfused concatenations:
    node rows k = [diag(mask), diag(deg), A^powers..., Pm, Pd],
    edge rows k = [diag(emask), diag(dL), AL^powers..., Pm^T, Pd^T].
    """

    t_node: torch.Tensor  # (B, J+2+2, N, N+M)
    t_edge: torch.Tensor  # (B, J+2+2, M, N+M)
    J: int

    @classmethod
    def from_dense(cls, b: DenseBundle) -> "FusedLGBundle":
        s_src, s_dst = b.s_src, b.s_dst
        B, N, M = s_src.shape
        J, dt, dev = b.J, s_src.dtype, s_src.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        eye_n = torch.eye(N, dtype=dt, device=dev)
        eye_m = torch.eye(M, dtype=dt, device=dev)
        mask = (b.node_mask.to(dt) if b.node_mask is not None
                else torch.ones((B, N), dtype=dt, device=dev))
        emask = (b.edge_mask.to(dt) if b.edge_mask is not None
                 else torch.ones((B, M), dtype=dt, device=dev))

        diag_mask = (eye_n[None] * mask[:, :, None])[:, None]
        diag_deg = (eye_n[None] * b.deg[:, :, None])[:, None]
        node_x_blocks = torch.cat([diag_mask, diag_deg, b.adj_powers], dim=1)
        t_node = torch.cat([
            torch.cat([node_x_blocks, zeros(B, J + 2, N, M)], -1),
            torch.cat([zeros(B, 1, N, N), (s_src + s_dst)[:, None]], -1),
            torch.cat([zeros(B, 1, N, N), (s_src - s_dst)[:, None]], -1),
        ], dim=1)

        # AL[e, e'] = sum_n S_dst[n,e] S_src[n,e'] w[e'] - 1[e'=rev(e)] w[e']
        sw = s_src * b.w[:, None, :]
        al = D._acc_einsum("bne,bnf->bef", s_dst, sw)
        al = al - F.one_hot(b.rev.long(), M).to(dt) * b.w[:, None, :]
        al_powers = [al]
        cur = al
        for _ in range(1, J):
            cur = D._acc_einsum("bef,bfg->beg", cur, cur)
            al_powers.append(cur)
        diag_emask = (eye_m[None] * emask[:, :, None])[:, None]
        diag_dl = (eye_m[None] * b.dl[:, :, None])[:, None]
        edge_xl_blocks = torch.cat(
            [diag_emask, diag_dl, torch.stack(al_powers, dim=1)], dim=1)
        pm_t = (s_src + s_dst).transpose(1, 2)
        pd_t = (s_src - s_dst).transpose(1, 2)
        t_edge = torch.cat([
            torch.cat([zeros(B, J + 2, M, N), edge_xl_blocks], -1),
            torch.cat([pm_t[:, None], zeros(B, 1, M, M)], -1),
            torch.cat([pd_t[:, None], zeros(B, 1, M, M)], -1),
        ], dim=1)
        return cls(t_node=t_node, t_edge=t_edge, J=J)

    def _apply(self, t, spec, x, xl, lead_width, tail_width):
        """The combined apply. Mismatched feature widths (only the model's
        first layer has them: x has the input width, xl starts at 1) are
        zero-padded to a common width and the blocks sliced back. The
        operand is always [x; xl]; the first J+2 row blocks give
        lead_width-wide features, the last two tail_width-wide ones."""
        fx, fl = x.shape[-1], xl.shape[-1]
        fc = max(fx, fl)
        xp = F.pad(x, (0, fc - fx))
        xlp = F.pad(xl, (0, fc - fl))
        out = D._acc_einsum(spec, t, torch.cat([xp, xlp], dim=1))
        B, rows, K, _ = out.shape
        if fx == fl:
            return out.reshape(B, rows, K * fc)
        lead = out[:, :, : self.J + 2, :lead_width].reshape(B, rows, -1)
        tail = out[:, :, self.J + 2:, :tail_width].reshape(B, rows, -1)
        return torch.cat([lead, tail], dim=-1)

    def node_input(self, x: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
        """[graph_op(x) | Pm xl | Pd xl] as one matmul."""
        return self._apply(self.t_node, "bknv,bvf->bnkf", x, xl,
                           x.shape[-1], xl.shape[-1])

    def edge_input(self, x: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
        """[lg_graph_op(xl) | Pm^T x | Pd^T x] as one matmul."""
        return self._apply(self.t_edge, "bkmv,bvf->bmkf", x, xl,
                           xl.shape[-1], x.shape[-1])


@dataclasses.dataclass
class MaterializedBundle:
    """Bundle over explicit dense operator tensors."""

    W: torch.Tensor  # (B, N, N, J+2)
    WL: torch.Tensor | None = None  # (B, M, M, J+2)
    Pm: torch.Tensor | None = None  # (B, N, M)
    Pd: torch.Tensor | None = None

    @property
    def has_line_graph(self) -> bool:
        return self.WL is not None

    def graph_op(self, x: torch.Tensor) -> torch.Tensor:
        return D.graph_op_materialized(self.W, x)

    def lg_graph_op(self, xl: torch.Tensor) -> torch.Tensor:
        return D.graph_op_materialized(self.WL, xl)

    def pm_pd(self, xl: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.einsum("bnm,bmf->bnf", self.Pm, xl),
                          torch.einsum("bnm,bmf->bnf", self.Pd, xl)], dim=-1)

    def pm_pd_t(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.einsum("bnm,bnf->bmf", self.Pm, x),
                          torch.einsum("bnm,bnf->bmf", self.Pd, x)], dim=-1)

    def edge_features(self) -> torch.Tensor:
        dl = torch.diagonal(self.WL[:, :, :, 1], dim1=1, dim2=2)
        return dl[:, :, None]
