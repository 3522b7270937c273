"""GNN layers (counterpart of hgnn2_tpu/nn/layers.py): the initializer,
the compat flags, the padding-aware batch norm, the per-graph spatial
normalization, the GRU update, and the power and line-graph GNNs' layers
over an operator bundle.

Submodules carry the flax names (cv1, cv2, gru.ih, gru.hh, bn, fc;
node_cv1, edge_bn... in the line-graph layers), so
hgnn2_torch.convert maps weights one to one. Parameters and BN statistics
stay float32; a layer's ``dtype`` (bf16 mixed precision) is the dtype its
Linear layers compute in, as flax's Dense(dtype=...).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from hgnn2_torch.nn.bundles import DenseBundle
from hgnn2_torch.ops import bn_fused, power_layer
from hgnn2_torch.parallel import spmd


def ref_init(tensor: torch.Tensor, scale: float = 0.1,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """N(0, scale) in place: the initializer used throughout the original
    models. It gives other numbers than flax's from the same seed; weights
    shared with the JAX package go through hgnn2_torch.convert."""
    with torch.no_grad():
        return tensor.normal_(0.0, scale, generator=generator)


def ref_linear(fan_in: int, fan_out: int,
               generator: torch.Generator | None = None) -> nn.Linear:
    """A Linear layer with weight and bias drawn by ref_init."""
    lin = nn.Linear(fan_in, fan_out)
    ref_init(lin.weight, generator=generator)
    ref_init(lin.bias, generator=generator)
    return lin


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """float32 for bf16 and f32, float64 for f64: the dtype of the
    statistics and sums that stay f32 under mixed precision."""
    return torch.promote_types(dtype, torch.float32)


def _dense(lin: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """lin(x) computed in ``dtype``, or else in the promoted dtype of x and
    the (f32) weights, as flax's Dense computes."""
    dt = dtype or torch.promote_types(x.dtype, lin.weight.dtype)
    return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))


def pair_conv(cv1: nn.Linear, cv2: nn.Linear, x1: torch.Tensor,
              relu_second: bool, dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """concat([cv2(x1), relu(cv1(x1))]), cv2 through a ReLU too iff
    relu_second: the two convolutions of every GNN layer, concatenated in
    the original layers' order (cv2, cv1)."""
    a = torch.relu(_dense(cv1, x1, dtype))
    b = _dense(cv2, x1, dtype)
    if relu_second:
        b = torch.relu(b)
    return torch.cat([b, a], dim=-1)


@dataclasses.dataclass(frozen=True)
class CompatConfig:
    """Flags reproducing the original implementation's quirks (parity)."""

    scalar_affine_bn: bool = False  # 0-d BN scale and bias
    mask_bn_output: bool = True  # False: padded positions leak out of BN
    mask_readout_bias: bool = True  # False: bias * Nmax in the readout sum
    bn_running_std_init_zero: bool = False  # running std starts at 0

    @classmethod
    def reference(cls) -> "CompatConfig":
        return cls(scalar_affine_bn=True, mask_bn_output=False,
                   mask_readout_bias=False, bn_running_std_init_zero=True)


class MaskedBatchNorm(nn.Module):
    """Padding-aware batch norm: one masked mean and std per feature over
    every valid position of the whole input (h (..., F), mask (...)).

    Not torch.nn.BatchNorm: it tracks the std, std = sqrt(eps + sq /
    count) with count clamped to at least 1, and in train mode updates
    running <- (1 - momentum) * batch + momentum * running with momentum
    0.1. The running std starts at 1 (0 under compat). Parameters
    ``scale`` and ``bias`` (0-d under scalar_affine_bn) and buffers
    ``mean`` and ``std`` carry the flax names. Computes in float32 (float64
    for a float64 input) and returns the input's dtype. In train mode on
    CUDA in float32 with statistics of its own input, the forward and the
    backward are one kernel each (ops/bn_fused.py); elsewhere the same
    math runs as PyTorch ops (bn_fused.composed).

    axis_name (a mesh axis, "edge", or a tuple of them, ("data", "edge"))
    pools the statistics over every rank of those axes, as the JAX
    module does inside a shard_map: count and total are summed over the
    ranks (parallel.spmd.psum) before the mean, then the squared
    deviations about that pooled mean. The input is then the ranks'
    molecule-aligned shards laid end to end (spmd.flatten_shards).
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, compat: CompatConfig = CompatConfig(),
                 axis_name: str | tuple[str, ...] | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if axis_name is not None:
            spmd.mesh_axes(axis_name)
        self.momentum, self.eps, self.compat = momentum, eps, compat
        self.axis_name = axis_name
        pshape = () if compat.scalar_affine_bn else (num_features,)
        self.scale = nn.Parameter(ref_init(torch.empty(pshape), generator=generator))
        self.bias = nn.Parameter(ref_init(torch.empty(pshape), generator=generator))
        self.register_buffer("mean", torch.zeros(num_features))
        std0 = torch.zeros if compat.bn_running_std_init_zero else torch.ones
        self.register_buffer("std", std0(num_features))

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.axis_name is None else spmd.psum(x, self.axis_name)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        in_dtype = h.dtype
        h = h.to(_at_least_f32(h.dtype))
        m = mask.to(h.dtype)
        args = (self.scale, self.bias, self.mean, self.std, self.momentum,
                self.eps, self.compat.mask_bn_output)
        if bn_fused.use_kernel(h.device, h.dtype, self.training,
                               self.axis_name):
            out = bn_fused.masked_batch_norm(h, m, *args)
        else:
            out, _ = bn_fused.composed(h, m, *args, training=self.training,
                                       psum=self._psum)
        return out.to(in_dtype)


def spatial_normalization(h: torch.Tensor, mask: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """Per-graph, per-feature standardization over the valid nodes (the
    older generation's alternative to batch norm). h (B, N, F), mask
    (B, N)."""
    m = mask[..., None]
    hm = h * m
    count = mask.sum(dim=1, keepdim=True).clamp_min(1.0)[..., None]
    mean = hm.sum(dim=1, keepdim=True) / count
    centered = (hm - mean) * m
    var = eps + (centered ** 2).sum(dim=1, keepdim=True) / count
    return centered / torch.sqrt(var)


class GRUUpdate(nn.Module):
    """Gated node-state update: ih = Linear(fan_in, 3 features) on the
    input, hh = Linear(features, 3 features) on the hidden state, each
    chunked into (r, z, n) thirds:
        r = sigmoid(r_i + r_h); z = sigmoid(z_i + z_h)
        n = tanh(n_i + r * n_h); out = (1 - z) * n + z * h
    It computes in the promoted dtype of its input and its f32 weights,
    as the flax module (whose Dense layers have no dtype) does."""

    def __init__(self, fan_in: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.ih = ref_linear(fan_in, 3 * features, generator)
        self.hh = ref_linear(features, 3 * features, generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        r_i, z_i, n_i = _dense(self.ih, x).chunk(3, dim=-1)
        r_h, z_h, n_h = _dense(self.hh, h).chunk(3, dim=-1)
        r = torch.sigmoid(r_i + r_h)
        z = torch.sigmoid(z_i + z_h)
        n = torch.tanh(n_i + r * n_h)
        return (1.0 - z) * n + z * h


class PowerLayer(nn.Module):
    """One power-GNN iteration over x1 = bundle.graph_op(x):
    BN(concat([relu(cv2(x1)), relu(cv1(x1))])), the concat in the order
    (cv2, cv1). gru applies GRUUpdate(x1, z) to the concat z before BN.
    In train mode on CUDA in float32 over a DenseBundle, without the GRU
    or pooled statistics and within the kernels' shapes
    (power_layer.use_kernel), the whole layer is one kernel forward and
    one backward (ops/power_layer.py); elsewhere it runs as PyTorch ops,
    its batch norm through self.bn."""

    def __init__(self, fan_in: int, features_out: int,
                 compat: CompatConfig = CompatConfig(),
                 dtype: torch.dtype | None = None, gru: bool = False,
                 bn_axis: str | tuple[str, ...] | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.cv1 = ref_linear(fan_in, features_out, generator)
        self.cv2 = ref_linear(fan_in, features_out, generator)
        self.gru = (GRUUpdate(fan_in, 2 * features_out, generator)
                    if gru else None)
        self.bn = MaskedBatchNorm(2 * features_out, compat=compat,
                                  axis_name=bn_axis, generator=generator)

    def takes_kernel(self, bundle, x: torch.Tensor) -> bool:
        """Whether a call on (bundle, x) runs the kernels
        (power_layer.use_kernel over a DenseBundle with a node mask)."""
        dense = (isinstance(bundle, DenseBundle)
                 and bundle.node_mask is not None)
        return power_layer.use_kernel(
            x, bundle.adj_powers if dense else None, self.cv1.out_features,
            self.training, self.dtype, self.bn.axis_name, self.gru is not None)

    def forward(self, bundle, x: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        if self.takes_kernel(bundle, x):
            bn = self.bn
            return power_layer.power_layer(
                x, bundle.adj_powers, bundle.deg, bundle.node_mask, mask,
                self.cv1.weight, self.cv1.bias, self.cv2.weight,
                self.cv2.bias, bn.scale, bn.bias, bn.mean, bn.std,
                bn.momentum, bn.eps, bn.compat.mask_bn_output)
        x1 = bundle.graph_op(x)
        z = pair_conv(self.cv1, self.cv2, x1, True, self.dtype)
        if self.gru is not None:
            z = self.gru(x1, z)
        return self.bn(z, mask)


class ReadoutLayer(nn.Module):
    """Final readout: sum over nodes of fc(bundle.graph_op(x)), in f32.
    The bias is masked to the real nodes unless compat turns that off
    (then each graph adds bias x N_bucket)."""

    def __init__(self, fan_in: int, features_out: int,
                 compat: CompatConfig = CompatConfig(),
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compat, self.dtype = compat, dtype
        self.fc = ref_linear(fan_in, features_out, generator)

    def forward(self, bundle, x: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        y = _dense(self.fc, bundle.graph_op(x), self.dtype)
        if self.compat.mask_readout_bias:
            y = y * mask[..., None]
        return y.to(_at_least_f32(y.dtype)).sum(dim=1)


class LGLayer(nn.Module):
    """One line-graph GNN iteration over node state x (B, N, x_width) and
    edge state xl (B, M, xl_width). order selects the update schedule:
      1: node update first, the edge update sees the new node state;
      2: edge update first (on the old x), the node update sees the new
         edge state;
      3: both read the previous states.
    Node input [graph_op(x) | Pm e | Pd e], edge input [lg_graph_op(xl) |
    Pm^T n | Pd^T n], e and n the states the schedule wires in; each
    update is BN(concat([cv2, relu(cv1)])), node BN over the node mask and
    edge BN over the edge mask. The fan-ins follow from the order."""

    def __init__(self, x_width: int, xl_width: int, features_out: int,
                 J: int = 1, order: int = 1,
                 compat: CompatConfig = CompatConfig(),
                 dtype: torch.dtype | None = None,
                 bn_axis: str | tuple[str, ...] | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if order not in (1, 2, 3):
            raise ValueError(f"order must be 1, 2 or 3; got {order}")
        self.order, self.dtype = order, dtype
        state = 2 * features_out
        node_edge_w = state if order == 2 else xl_width
        edge_node_w = state if order == 1 else x_width
        for prefix, fan_in in (
                ("node_", (J + 2) * x_width + 2 * node_edge_w),
                ("edge_", (J + 2) * xl_width + 2 * edge_node_w)):
            self.add_module(f"{prefix}cv1", ref_linear(fan_in, features_out,
                                                       generator))
            self.add_module(f"{prefix}cv2", ref_linear(fan_in, features_out,
                                                       generator))
            self.add_module(f"{prefix}bn", MaskedBatchNorm(
                state, compat=compat, axis_name=bn_axis, generator=generator))

    def _pair(self, prefix: str, x1: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        z = pair_conv(getattr(self, f"{prefix}cv1"),
                      getattr(self, f"{prefix}cv2"), x1, False, self.dtype)
        return getattr(self, f"{prefix}bn")(z, mask)

    def forward(self, bundle, x: torch.Tensor, xl: torch.Tensor,
                mask: torch.Tensor, edge_mask: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        xa = bundle.graph_op(x)
        xda = bundle.lg_graph_op(xl)

        def node_update(edge_state):
            x1 = torch.cat([xa, bundle.pm_pd(edge_state)], dim=-1)
            return self._pair("node_", x1, mask)

        def edge_update(node_state):
            xd1 = torch.cat([xda, bundle.pm_pd_t(node_state)], dim=-1)
            return self._pair("edge_", xd1, edge_mask)

        if self.order == 1:
            z = node_update(xl)
            zl = edge_update(z)
        elif self.order == 2:
            zl = edge_update(x)
            z = node_update(zl)
        else:
            z = node_update(xl)
            zl = edge_update(x)
        return z, zl


class LGReadoutLayer(nn.Module):
    """Line-graph readout: sum over nodes of fc([graph_op(x) | Pm xl |
    Pd xl]), in f32, the bias masked to the real nodes unless compat turns
    that off."""

    def __init__(self, fan_in: int, features_out: int,
                 compat: CompatConfig = CompatConfig(),
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compat, self.dtype = compat, dtype
        self.fc = ref_linear(fan_in, features_out, generator)

    def forward(self, bundle, x: torch.Tensor, xl: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        x1 = torch.cat([bundle.graph_op(x), bundle.pm_pd(xl)], dim=-1)
        y = _dense(self.fc, x1, self.dtype)
        if self.compat.mask_readout_bias:
            y = y * mask[..., None]
        return y.to(_at_least_f32(y.dtype)).sum(dim=1)
