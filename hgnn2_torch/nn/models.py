"""GNN models over dense batches (counterpart of hgnn2_tpu/nn/models.py).

GNNSimple, the power GNN, is layer0 (input width) + (n_layers - 2)
middle layers + a readout, with widths [(J+2) in -> h], [(J+2) 2h -> h],
[(J+2) 2h -> out]. Submodules carry the flax names (``layer{i}``,
``layerlast``), so hgnn2_torch.convert maps the nested flax trees one to
one. Train mode is ``module.train()``: batch norm then uses batch
statistics and updates its running ones. The line-graph GNN comes with
the line-graph slice.
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
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_features, self.n_layers = n_features, n_layers
        self.dim_output, self.J, self.dtype = dim_output, J, dtype
        width = in_features
        for i in range(n_layers - 1):
            self.add_module(f"layer{i}", layers.PowerLayer(
                (J + 2) * width, n_features, compat, dtype=dtype, gru=gru,
                generator=generator))
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
