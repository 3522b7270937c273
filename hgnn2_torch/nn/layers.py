"""Layer helpers (counterpart of hgnn2_tpu/nn/layers.py). Only the
initializer the CCN models use is ported so far."""

from __future__ import annotations

import torch


def ref_init(tensor: torch.Tensor, scale: float = 0.1,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """N(0, scale) in place: the initializer used throughout the original
    models. It gives other numbers than flax's from the same seed; weights
    shared with the JAX package go through hgnn2_torch.convert."""
    with torch.no_grad():
        return tensor.normal_(0.0, scale, generator=generator)
