"""Covariant compositional networks, CCN-1D and CCN-2D
(counterpart of hgnn2_tpu/nn/ccn.py).

Every vertex of every graph in a batch advances together: per-vertex
ragged states become (V, K, C) / (V, K, K, C) with K the padded
receptive-field size and a row mask, and the chi matrices are the index
table chi_idx (V, K, K). Each layer is promotion + contraction, then
Linear, ReLU and the row mask. With ``kernel=True`` the promotion +
contraction is one fused CUDA kernel forward and one backward
(ops/ccn_fused.promote_contract_*); otherwise it is the plain PyTorch
version, whose promotion backward is the gather-form adjoint; CCN2D
also has the JAX package's two memory-bounded strategies for high K
(scan_promotion, vertex_chunks). The forward is the same in train and
eval mode (no BN, no dropout).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from hgnn2_torch import native, resolve_device
from hgnn2_torch.graphs import GraphRecord
from hgnn2_torch.nn.layers import ref_linear
from hgnn2_torch.ops import ccn_fused, contractions, sparse


@dataclasses.dataclass
class CCNBatch:
    """All vertices of a batch of graphs, flattened and degree-padded.

    x:        (V, F) float32 raw node features
    nbr:      (V, K) int32 global vertex index of each neighbor (self-loop
              included when add_self_loops; padding slots point at 0 but
              carry chi_idx = -1 so they contribute nothing)
    chi_idx:  (V, K, K) int32: chi_idx[v,k,a] = b iff nbrs[v][a] ==
              nbrs[nbr[v,k]][b], else -1
    rslot:    (V, K) int32 slot of v in its k-th neighbor's list (-1 at
              padding); the promotion backward reads it
    deg:      (V,) float32 true receptive-field size d_v
    row_mask: (V, K) float32 1.0 where slot < d_v
    vmask:    (V,) float32 1.0 for real vertices
    gid:      (V,) int32 graph id (padding rows -> n_graphs)
    y:        (B,) targets
    gmask:    (B,) float32 1.0 for real graphs (0 for batch-size padding)
    """

    x: torch.Tensor
    nbr: torch.Tensor
    chi_idx: torch.Tensor
    rslot: torch.Tensor
    deg: torch.Tensor
    row_mask: torch.Tensor
    vmask: torch.Tensor
    gid: torch.Tensor
    y: torch.Tensor
    gmask: torch.Tensor
    n_graphs: int = 0


def make_ccn_batch(
    records: Sequence[GraphRecord],
    k_max: int | None = None,
    vertex_capacity: int | None = None,
    add_self_loops: bool = True,
    task: int | None = None,
    batch_size: int | None = None,
    feature_dim: int | None = None,
    y_dtype=None,
    device: str | torch.device | None = None,
) -> CCNBatch:
    """Builds the batched chi/neighbor tables on the host, each graph's
    through the C++ library (hgnn2_torch.native) when it is available,
    else with numpy (the same tables), and moves them to ``device``
    (default cuda) once.

    add_self_loops uses A + I, which guarantees chi_ii exists. batch_size
    pads the graph axis with empty graphs (gmask 0) so a serving bucket
    keeps one shape. An empty record list builds an all-padding batch;
    k_max and feature_dim must then be given (y_dtype, default float32).
    """
    dev = resolve_device(device)
    bs = len(records)
    B = batch_size or bs
    nbr_lists: list[list[np.ndarray]] = []
    for r in records:
        A = np.asarray(r.adj)
        if add_self_loops:
            A = A + np.eye(A.shape[0], dtype=A.dtype)
        # neighbor lists in ascending index order
        nbr_lists.append([np.nonzero(A[i] > 0)[0] for i in range(A.shape[0])])

    tot_v = sum(r.n_nodes for r in records)
    V = vertex_capacity or tot_v
    if tot_v > V:
        raise ValueError(f"vertex capacity too small: {tot_v} > {V}")
    max_deg = max((len(l) for ls in nbr_lists for l in ls), default=0)
    K = k_max or max_deg
    if not K:
        raise ValueError("k_max is required for an empty record list")
    if max_deg > K:
        raise ValueError(f"max receptive-field size {max_deg} exceeds k_max={K}")
    if records:
        F = records[0].x.shape[1]
    elif feature_dim is not None:
        F = feature_dim
    else:
        raise ValueError("feature_dim is required for an empty record list")

    x = np.zeros((V, F), dtype=np.float32)
    nbr = np.zeros((V, K), dtype=np.int32)
    chi_idx = np.full((V, K, K), -1, dtype=np.int32)
    rslot = np.full((V, K), -1, dtype=np.int32)
    deg = np.zeros((V,), dtype=np.float32)
    row_mask = np.zeros((V, K), dtype=np.float32)
    vmask = np.zeros((V,), dtype=np.float32)
    gid = np.full((V,), B, dtype=np.int32)

    use_native = native.available()
    off = 0
    ys = []
    for g, (r, lists) in enumerate(zip(records, nbr_lists)):
        n = r.n_nodes
        x[off : off + n] = r.x
        gid[off : off + n] = g
        vmask[off : off + n] = 1.0
        degs = np.array([len(l) for l in lists], dtype=np.int32)
        if use_native:
            offsets = np.zeros(n + 1, np.int32)
            np.cumsum(degs, out=offsets[1:])
            flat = (np.concatenate(lists).astype(np.int32) if lists
                    else np.zeros(0, np.int32))
            native.build_chi_tables_native(offsets, flat, K, off, chi_idx,
                                           rslot, nbr, deg, row_mask)
        else:
            # chi_idx[v,k,a] = position of lists[v][a] in lists[lists[v][k]],
            # else -1
            L = np.full((n, K), -1, dtype=np.int64)
            for i, li in enumerate(lists):
                L[i, : len(li)] = li
            pos = np.full((n, n), -1, dtype=np.int32)
            if degs.sum():
                u_idx = np.repeat(np.arange(n), degs)
                pos[u_idx, np.concatenate(lists)] = np.concatenate(
                    [np.arange(d) for d in degs])
            safe = np.where(L >= 0, L, 0)
            ci = pos[safe[:, :, None], safe[:, None, :]]  # (n, K, K)
            invalid = (L[:, :, None] < 0) | (L[:, None, :] < 0)
            chi_idx[off : off + n] = np.where(invalid, -1, ci)
            # rslot[v, k] = slot of v in lists[L[v, k]]
            rs = pos[safe, np.arange(n)[:, None]]
            rslot[off : off + n] = np.where(L >= 0, rs, -1)
            deg[off : off + n] = degs
            row_mask[off : off + n] = (L >= 0).astype(np.float32)
            nbr[off : off + n] = np.where(L >= 0, L + off, 0).astype(np.int32)
        off += n
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
    arrays = dict(x=x, nbr=nbr, chi_idx=chi_idx, rslot=rslot, deg=deg,
                  row_mask=row_mask, vmask=vmask, gid=gid, y=y, gmask=gmask)
    return CCNBatch(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()},
                    n_graphs=B)


class _CCN(nn.Module):
    """Shared skeleton: layers w1..wL, the readout after the input and
    after every layer, and the final fc over the concatenated readouts of
    width n_features + n_layers * hidden."""

    order = 0  # receptive-field axes of the state: 1 (CCN-1D) or 2 (CCN-2D)
    n_channels = 0  # contraction channels per input channel

    def __init__(self, n_features: int, hidden: int = 2, n_layers: int = 2,
                 dim_output: int = 1, kernel: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_features, self.hidden = n_features, hidden
        self.n_layers, self.dim_output = n_layers, dim_output
        self.kernel = kernel
        width = n_features
        for i in range(n_layers):
            self.add_module(f"w{i + 1}",
                            ref_linear(self.n_channels * width, hidden, generator))
            width = hidden
        self.fc = ref_linear(n_features + n_layers * hidden, dim_output, generator)

    def _readout(self, f: torch.Tensor, cb: CCNBatch) -> torch.Tensor:
        per_vertex = f.sum(dim=tuple(range(1, 1 + self.order)))
        return sparse.graph_readout(per_vertex * cb.vmask[:, None], cb.gid,
                                    cb.n_graphs)

    def _mask(self, cb: CCNBatch) -> torch.Tensor:
        raise NotImplementedError

    def _contract(self, cb: CCNBatch, f: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, cb: CCNBatch) -> torch.Tensor:
        mask = self._mask(cb)[..., None]  # (V, K[, K], 1)
        f = cb.x.reshape(cb.x.shape[0], *(1,) * self.order, -1) * mask
        layer_sums = [self._readout(f, cb)]
        for i in range(self.n_layers):
            f = self._layer(getattr(self, f"w{i + 1}"), cb, f, mask)
            layer_sums.append(self._readout(f, cb))
        return self.fc(torch.cat(layer_sums, dim=-1))

    def _layer(self, dense: nn.Linear, cb: CCNBatch, f: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        return torch.relu(dense(self._contract(cb, f))) * mask


class CCN1D(_CCN):
    """First-order CCN. Per layer: promote neighbor states through chi,
    contract (row/col sums, 2 contractions), shared Linear + ReLU."""

    order = 1
    n_channels = 2

    def _mask(self, cb):
        return cb.row_mask

    def _contract(self, cb, f):
        if self.kernel:
            return ccn_fused.promote_contract_1d(cb.chi_idx, cb.nbr, f,
                                                 cb.rslot)
        return contractions.contract_1d(
            contractions.promote_1d(cb.chi_idx, cb.nbr, f, rslot=cb.rslot))


class CCN2D(_CCN):
    """Second-order CCN. Per layer: 2D promotion chi F chi^T, the 18 fused
    contractions, shared Linear + ReLU. compat_contractions reproduces the
    original implementation's duplicated contraction channels.

    Four strategies for the promotion's memory, equal by test, chosen as
    the JAX package chooses them (first that applies):
      * kernel=True: the fused CUDA kernels (K <= 8); T is never
        materialized and the other two flags are ignored;
      * scan_promotion=True: contractions.promote_contract_18_fused, a
        loop over the neighbour slots with each slot recomputed in the
        backward; O(V K^2 C) memory, the high-K regime;
      * vertex_chunks > 1: _chunked_layer, the layer over that many equal
        vertex slices in turn (caps the forward's T at a slice's; the
        backward keeps each slice's gather indices);
      * else the (V, K, K, K, C) promotion tensor with the gather-form
        promotion backward.
    """

    order = 2
    n_channels = 18

    def __init__(self, n_features: int, hidden: int = 2, n_layers: int = 2,
                 dim_output: int = 1, kernel: bool = False,
                 compat_contractions: bool = False, vertex_chunks: int = 1,
                 scan_promotion: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(n_features, hidden, n_layers, dim_output, kernel,
                         generator)
        self.compat_contractions = compat_contractions
        self.vertex_chunks = vertex_chunks
        self.scan_promotion = scan_promotion

    def _mask(self, cb):
        return cb.row_mask[:, :, None] * cb.row_mask[:, None, :]

    def _layer(self, dense, cb, f, mask):
        if self.kernel or self.scan_promotion or self.vertex_chunks <= 1:
            return super()._layer(dense, cb, f, mask)
        return self._chunked_layer(dense, cb, f, mask)

    def _contract(self, cb, f):
        if self.kernel:
            return ccn_fused.promote_contract_18(
                cb.chi_idx, cb.nbr, f, cb.deg, cb.row_mask, cb.rslot,
                compat=self.compat_contractions)
        if self.scan_promotion:
            return contractions.promote_contract_18_fused(
                cb.chi_idx, cb.nbr, f, cb.deg, cb.row_mask,
                compat=self.compat_contractions)
        return contractions.contract_18(
            contractions.promote_2d(cb.chi_idx, cb.nbr, f, rslot=cb.rslot),
            cb.deg, cb.row_mask, compat=self.compat_contractions)

    def _chunked_layer(self, dense, cb, f, mask2):
        """The layer over vertex_chunks equal vertex slices in turn, each
        promoting from the whole f (its neighbours may lie in any slice)
        through the plain gather (no rslot, as in the JAX package), then
        contract_18, Linear, ReLU and the mask; the slices concatenated."""
        v = f.shape[0]
        n_chunks = self.vertex_chunks
        if v % n_chunks:
            raise ValueError(f"vertex count {v} not divisible by {n_chunks}")
        vc = v // n_chunks
        out = []
        for lo in range(0, v, vc):
            rows = slice(lo, lo + vc)
            t = contractions.promote_2d(cb.chi_idx[rows], cb.nbr[rows], f)
            z = contractions.contract_18(t, cb.deg[rows], cb.row_mask[rows],
                                         compat=self.compat_contractions)
            out.append(torch.relu(dense(z)) * mask2[rows])
        return torch.cat(out)
