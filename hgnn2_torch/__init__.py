"""hgnn2_torch: the PyTorch + CUDA port of hgnn2_tpu for NVIDIA Hopper.

Module names mirror ``hgnn2_tpu`` so each piece has an obvious
counterpart. The package imports torch and numpy only. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; asking for CUDA where
there is none raises instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, never a
    silent fallback. Raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
