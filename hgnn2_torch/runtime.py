"""Runtime setup: the precision policy (counterpart of
hgnn2_tpu/runtime.py). The kernels are built by ops/cuda_build.py, so
there is no compilation cache to set up. Call setup() at process start;
cli.common.run_experiment does.
"""

from __future__ import annotations

import torch


def setup() -> None:
    """Float32 matmuls and convolutions without TF32, so the card
    computes what the CPU computes: the port always runs full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
