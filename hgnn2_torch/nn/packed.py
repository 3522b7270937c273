"""Packed-sparse GNNs over flat node/edge arrays (counterpart of
hgnn2_tpu/nn/packed.py).

The models are written against an operator bundle (graph_op,
lg_graph_op, pm, pd, pm_t, pd_t, nb_degrees): SparsePackedOps runs them
on one device, parallel.spmd.partitioned_packed_ops with the edge set
split over the ranks of a mesh. Module names follow the flax models'
(``layer{i}_node_cv1``, ``layer{i}_edge_bn``, ``fc``...), so
hgnn2_torch.convert maps weights one to one. Train mode is
``module.train()``: BatchNorm then uses batch statistics and updates its
running ones.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from hgnn2_torch.graphs import PackedGraphBatch
from hgnn2_torch.nn.layers import CompatConfig, MaskedBatchNorm, ref_init
from hgnn2_torch.ops import sparse


class SparsePackedOps:
    """Single-device operator bundle over a PackedGraphBatch."""

    def __init__(self, pb: PackedGraphBatch, J: int):
        self.pb, self.J = pb, J
        self.V = pb.num_node_slots
        self.deg = sparse.degrees(pb.src, pb.w, self.V)
        self.dl = sparse.nb_degrees(pb.src, pb.dst, pb.w, pb.rev,
                                    pb.edge_mask, self.V)

    def graph_op(self, x: torch.Tensor) -> torch.Tensor:
        pb = self.pb
        return sparse.graph_op(pb.src, pb.dst, pb.w, x, self.V, self.J,
                               deg=self.deg)

    def lg_graph_op(self, xl: torch.Tensor) -> torch.Tensor:
        pb = self.pb
        return sparse.lg_graph_op(pb.src, pb.dst, pb.w, pb.rev, pb.edge_mask,
                                  xl, self.V, self.J, dl=self.dl)

    def pm(self, xl: torch.Tensor) -> torch.Tensor:
        pb = self.pb
        return sparse.incidence_apply(pb.src, pb.dst, pb.edge_mask, xl,
                                      self.V, False)

    def pd(self, xl: torch.Tensor) -> torch.Tensor:
        pb = self.pb
        return sparse.incidence_apply(pb.src, pb.dst, pb.edge_mask, xl,
                                      self.V, True)

    def pm_t(self, x: torch.Tensor) -> torch.Tensor:
        pb = self.pb
        return sparse.incidence_t_apply(pb.src, pb.dst, pb.edge_mask, x, False)

    def pd_t(self, x: torch.Tensor) -> torch.Tensor:
        pb = self.pb
        return sparse.incidence_t_apply(pb.src, pb.dst, pb.edge_mask, x, True)

    def nb_degrees(self) -> torch.Tensor:
        return self.dl


def _linear(fan_in: int, fan_out: int, generator) -> nn.Linear:
    lin = nn.Linear(fan_in, fan_out)
    ref_init(lin.weight, generator=generator)
    ref_init(lin.bias, generator=generator)
    return lin


class _PackedBase(nn.Module):
    def _pair(self, prefix: str, fan_in: int, generator) -> None:
        """Registers {prefix}cv1, {prefix}cv2 and {prefix}bn."""
        H = self.n_features
        self.add_module(f"{prefix}cv1", _linear(fan_in, H, generator))
        self.add_module(f"{prefix}cv2", _linear(fan_in, H, generator))
        self.add_module(f"{prefix}bn", MaskedBatchNorm(
            2 * H, compat=self.compat, axis_name=self.bn_axis,
            generator=generator))

    def _apply_pair(self, prefix: str, x1, mask, relu_second: bool):
        """BN(concat([cv2(x1), relu(cv1(x1))])): the concat order (cv2,
        cv1) of the original layers."""
        a = torch.relu(getattr(self, f"{prefix}cv1")(x1))
        b = getattr(self, f"{prefix}cv2")(x1)
        if relu_second:
            b = torch.relu(b)
        z = torch.cat([b, a], dim=-1)
        return getattr(self, f"{prefix}bn")(z[None], mask[None])[0]

    def _readout(self, x1, pb: PackedGraphBatch) -> torch.Tensor:
        y = self.fc(x1) * pb.node_mask[:, None]
        return sparse.graph_readout(y, pb.node_gid, pb.n_graphs)


class PackedLGGNN(_PackedBase):
    """Line-graph GNN over packed graphs. order selects the update
    schedule: 1 node then edge, 2 edge then node, 3 both from the previous
    states. in_features is the node feature width (the flax model reads
    it from its first input)."""

    def __init__(self, n_features: int, n_layers: int, in_features: int,
                 dim_output: int = 1, J: int = 1, order: int = 1,
                 compat: CompatConfig = CompatConfig(),
                 bn_axis: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if order not in (1, 2, 3):
            raise ValueError(f"order must be 1, 2 or 3; got {order}")
        self.n_features, self.n_layers = n_features, n_layers
        self.dim_output, self.J, self.order = dim_output, J, order
        self.compat, self.bn_axis = compat, bn_axis
        k = J + 2
        xw, xlw, state = in_features, 1, 2 * n_features
        for i in range(n_layers - 1):
            node_in = lambda edge_w: k * xw + 2 * edge_w
            edge_in = lambda node_w: k * xlw + 2 * node_w
            if order == 1:
                widths = (node_in(xlw), edge_in(state))
            elif order == 2:
                widths = (node_in(state), edge_in(xw))
            else:
                widths = (node_in(xlw), edge_in(xw))
            self._pair(f"layer{i}_node_", widths[0], generator)
            self._pair(f"layer{i}_edge_", widths[1], generator)
            xw = xlw = state
        self.fc = _linear(k * xw + 2 * xlw, dim_output, generator)

    def forward(self, pb: PackedGraphBatch, ops=None) -> torch.Tensor:
        if ops is None:
            ops = SparsePackedOps(pb, self.J)
        vmask, emask = pb.node_mask, pb.edge_mask
        x, xl = pb.x, ops.nb_degrees()[:, None]
        for i in range(self.n_layers - 1):
            xa = ops.graph_op(x * vmask[:, None])
            xda = ops.lg_graph_op(xl * emask[:, None])

            def node_update(edge_state, i=i, xa=xa):
                x1 = torch.cat([xa, ops.pm(edge_state), ops.pd(edge_state)], -1)
                return self._apply_pair(f"layer{i}_node_", x1, vmask, False)

            def edge_update(node_state, i=i, xda=xda):
                xd1 = torch.cat(
                    [xda, ops.pm_t(node_state), ops.pd_t(node_state)], -1)
                return self._apply_pair(f"layer{i}_edge_", xd1, emask, False)

            if self.order == 1:
                x = node_update(xl)
                xl = edge_update(x)
            elif self.order == 2:
                xl = edge_update(x)
                x = node_update(xl)
            else:
                x, xl = node_update(xl), edge_update(x)
        xm = xl * emask[:, None]
        x1 = torch.cat([ops.graph_op(x * vmask[:, None]), ops.pm(xm),
                        ops.pd(xm)], -1)
        return self._readout(x1, pb)


class PackedGNN(_PackedBase):
    """Power GNN over packed graphs. Takes a bare graph_op_fn or a whole
    operator bundle (ops=, of which it uses graph_op); with neither, the
    single-device segment sums."""

    def __init__(self, n_features: int, n_layers: int, in_features: int,
                 dim_output: int = 1, J: int = 1,
                 compat: CompatConfig = CompatConfig(),
                 bn_axis: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_features, self.n_layers = n_features, n_layers
        self.dim_output, self.J = dim_output, J
        self.compat, self.bn_axis = compat, bn_axis
        width = in_features
        for i in range(n_layers - 1):
            self._pair(f"layer{i}_", (J + 2) * width, generator)
            width = 2 * n_features
        self.fc = _linear((J + 2) * width, dim_output, generator)

    def forward(self, pb: PackedGraphBatch,
                graph_op_fn: Callable | None = None, ops=None) -> torch.Tensor:
        if graph_op_fn is None and ops is not None:
            graph_op_fn = ops.graph_op
        if graph_op_fn is None:
            V = pb.num_node_slots
            deg = sparse.degrees(pb.src, pb.w, V)

            def graph_op_fn(x):
                return sparse.graph_op(pb.src, pb.dst, pb.w, x, V, self.J,
                                       deg=deg)

        vmask = pb.node_mask
        x = pb.x
        for i in range(self.n_layers - 1):
            h = graph_op_fn(x * vmask[:, None])
            x = self._apply_pair(f"layer{i}_", h, vmask, True)
        return self._readout(graph_op_fn(x * vmask[:, None]), pb)
