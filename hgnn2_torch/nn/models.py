"""GNN models over dense batches (counterpart of hgnn2_tpu/nn/models.py):
the power GNN and the line-graph (edge-dual) GNN.

Each is layer0 (input width) + (n_layers - 2) middle layers + a readout,
with hidden widths [in -> h], [2h -> h], [2h -> out]. Submodules carry
the flax names (``layer{i}``, ``layerlast``; ``node_cv1``, ``edge_bn``...
inside a line-graph layer), so hgnn2_torch.convert maps the nested flax
trees one to one. Train mode is ``module.train()``: batch norm then uses
batch statistics and updates its running ones. bn_axis ("data") pools
those statistics over the processes of a data-parallel grid
(parallel/multihost.py), each holding its rows of the global batch; the
JAX models need none, XLA pooling the global batch.
"""

from __future__ import annotations

import torch
from torch import nn

from hgnn2_torch.graphs import DenseGraphBatch
from hgnn2_torch.nn import layers
from hgnn2_torch.nn.bundles import DenseBundle
from hgnn2_torch.nn.layers import CompatConfig


class GNNSimple(nn.Module):
    """Power GNN over the operator stack {I, D, A, A^2, A^4, ...}.

    in_features is the node feature width (the flax model reads it from
    its first batch). dtype=torch.bfloat16 computes in bf16 while the
    parameters, the BN statistics and the readout sum stay f32. gru adds
    the gated update to every non-readout layer."""

    def __init__(self, in_features: int, n_features: int, n_layers: int,
                 dim_output: int = 1, J: int = 1,
                 compat: CompatConfig = CompatConfig(),
                 dtype: torch.dtype | None = None, gru: bool = False,
                 bn_axis: str | tuple[str, ...] | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_features, self.n_features = in_features, n_features
        self.n_layers, self.dim_output = n_layers, dim_output
        self.J, self.compat, self.dtype, self.gru = J, compat, dtype, gru
        width = in_features
        for i in range(n_layers - 1):
            self.add_module(f"layer{i}", layers.PowerLayer(
                (J + 2) * width, n_features, compat, dtype=dtype, gru=gru,
                bn_axis=bn_axis, generator=generator))
            width = 2 * n_features
        self.layerlast = layers.ReadoutLayer(
            (J + 2) * width, dim_output, compat, dtype=dtype,
            generator=generator)

    def forward(self, batch: DenseGraphBatch) -> torch.Tensor:
        bundle = DenseBundle.from_batch(batch, self.J, dtype=self.dtype)
        x, mask = batch.x, batch.node_mask
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i in range(self.n_layers - 1):
            x = getattr(self, f"layer{i}")(bundle, x, mask)
        return self.layerlast(bundle, x, mask)


class GNNLineGraph(nn.Module):
    """GNN on the graph and its non-backtracking line graph.

    order selects the node/edge update schedule (1: node first, 2: edge
    first, 3: simultaneous). in_features is the node feature width; the
    edge state starts as the NB degrees (width 1). dtype=torch.bfloat16
    computes in bf16 while the parameters, the BN statistics and the
    readout sum stay f32."""

    def __init__(self, in_features: int, n_features: int, n_layers: int,
                 dim_output: int = 1, J: int = 1, order: int = 1,
                 compat: CompatConfig = CompatConfig(),
                 dtype: torch.dtype | None = None,
                 bn_axis: str | tuple[str, ...] | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_features, self.n_features = in_features, n_features
        self.n_layers, self.dim_output = n_layers, dim_output
        self.J, self.order, self.compat = J, order, compat
        self.dtype = dtype
        # layer0 is built even at n_layers = 1, as the flax model builds it
        self.n_lg_layers = max(n_layers - 1, 1)
        xw, xlw = in_features, 1
        for i in range(self.n_lg_layers):
            self.add_module(f"layer{i}", layers.LGLayer(
                xw, xlw, n_features, J=J, order=order, compat=compat,
                dtype=dtype, bn_axis=bn_axis, generator=generator))
            xw = xlw = 2 * n_features
        self.layerlast = layers.LGReadoutLayer(
            (J + 2) * xw + 2 * xlw, dim_output, compat, dtype=dtype,
            generator=generator)

    def forward(self, batch: DenseGraphBatch, bundle=None) -> torch.Tensor:
        """bundle: an operator bundle to use in place of the batch's own
        DenseBundle (a MaterializedBundle in the tests)."""
        if bundle is None:
            bundle = DenseBundle.from_batch(batch, self.J, with_line_graph=True,
                                            dtype=self.dtype)
        x, mask = batch.x, batch.node_mask
        if self.dtype is not None:
            x = x.to(self.dtype)
        edge_mask = batch.edge_mask
        if edge_mask is None:
            edge_mask = torch.ones(bundle.w.shape, dtype=x.dtype,
                                   device=x.device)
        xl = bundle.edge_features().to(x.dtype)
        for i in range(self.n_lg_layers):
            x, xl = getattr(self, f"layer{i}")(bundle, x, xl, mask, edge_mask)
        return self.layerlast(bundle, x, xl, mask)
