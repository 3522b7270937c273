"""Layer helpers (counterpart of hgnn2_tpu/nn/layers.py): the initializer,
the compat flags and the padding-aware batch norm of the packed models."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


def ref_init(tensor: torch.Tensor, scale: float = 0.1,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """N(0, scale) in place: the initializer used throughout the original
    models. It gives other numbers than flax's from the same seed; weights
    shared with the JAX package go through hgnn2_torch.convert."""
    with torch.no_grad():
        return tensor.normal_(0.0, scale, generator=generator)


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
    ``mean`` and ``std`` carry the flax names. Computes in float32 and
    returns the input's dtype.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, compat: CompatConfig = CompatConfig(),
                 axis_name: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                "molecule-aligned BN (axis_name) comes with the sharded "
                "training slice")
        self.momentum, self.eps, self.compat = momentum, eps, compat
        pshape = () if compat.scalar_affine_bn else (num_features,)
        self.scale = nn.Parameter(ref_init(torch.empty(pshape), generator=generator))
        self.bias = nn.Parameter(ref_init(torch.empty(pshape), generator=generator))
        self.register_buffer("mean", torch.zeros(num_features))
        std0 = torch.zeros if compat.bn_running_std_init_zero else torch.ones
        self.register_buffer("std", std0(num_features))

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        in_dtype = h.dtype
        h = h.float()
        m = mask.float()[..., None]
        hm = h * m
        if self.training:
            axes = tuple(range(h.dim() - 1))
            count = m.sum().clamp_min(1.0)
            mean = hm.sum(dim=axes) / count
            sq = (((hm - mean) * m) ** 2).sum(dim=axes)
            std = torch.sqrt(self.eps + sq / count)
            with torch.no_grad():
                self.mean.copy_((1.0 - self.momentum) * mean
                                + self.momentum * self.mean)
                self.std.copy_((1.0 - self.momentum) * std
                               + self.momentum * self.std)
        else:
            mean, std = self.mean, self.std
        out = self.scale * ((hm - mean) / std) + self.bias
        if self.compat.mask_bn_output:
            out = out * m
        return out.to(in_dtype)
