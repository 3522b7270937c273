"""Runtime setup: the precision policy (counterpart of
hgnn2_tpu/runtime.py). The kernels are built by ops/cuda_build.py, so
there is no compilation cache to set up. Call setup() at process start;
cli.common.run_experiment does. deterministic() fixes the summation
order of a block for checks that compare two runs.
"""

from __future__ import annotations

import contextlib
import warnings

import torch


def setup() -> None:
    """Float32 matmuls and convolutions without TF32, so the card
    computes what the CPU computes: the port always runs full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms(True) over the block, restored
    after it: index_add_ and the other scatter-adds on CUDA then sum in a
    fixed order instead of by atomics, so the same computation gives the
    same value run after run. warn_only: an op without a deterministic
    CUDA form runs as it is. Yields a list that gets, when the block
    ends, the messages of those ops."""
    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    refused: list[str] = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield refused
    finally:
        torch.use_deterministic_algorithms(was, warn_only=was_warn)
    refused.extend(sorted({str(w.message)[:160] for w in caught
                           if "determinis" in str(w.message)}))
