"""Ring all-reduce over the ranks of a single-device mesh: the wrapper of
kernel K5 in csrc/ring.cu (counterpart of hgnn2_tpu/ops/pallas/ring.py).

ring_psum(parts) takes one float32 tensor per rank and returns, for every
rank r, ((x_r + x_{r-1}) + x_{r-2}) + ... + x_{r-S+1}: the TPU kernel's
summation order. ring_psum_reference repeats the TPU kernel's hop
schedule in PyTorch and so defines that order; the kernel reads the S
inputs once in the same order, and the two agree bit for bit.

For CUDA tensors ring_psum launches one kernel a call (on the current
stream) and adds one to its ``launches`` count; a kernel that cannot
build or launch raises. For CPU tensors it runs
ring_psum_reference. Like the JAX package's ring, it has no gradient: it
refuses a tensor that requires grad while grad mode is on.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hgnn2_torch.ops import cuda_build

MAX_RANKS = 8  # the kernel's by-value pointer table; the JAX tests' largest mesh


@functools.cache
def _kernel():
    fn = cuda_build.load("ring").hgnn2_ring_allreduce
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [ptrs, ptrs, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ring_psum_reference(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The ring's hop schedule in PyTorch: on hop h every rank forwards
    the block it received on hop h - 1 (its own on hop 0) to its right
    neighbour and adds the block it receives into its output."""
    S = len(parts)
    out = list(parts)
    send = list(parts)
    for _ in range(S - 1):
        send = [send[(r - 1) % S] for r in range(S)]
        out = [out[r] + send[r] for r in range(S)]
    return out


def _check(parts: list[torch.Tensor]) -> None:
    if not parts:
        raise ValueError("ring_psum needs at least one rank")
    x0 = parts[0]
    for r, x in enumerate(parts):
        if x.shape != x0.shape or x.dtype != torch.float32:
            raise ValueError(
                f"rank {r}: every part must be float32 of shape "
                f"{tuple(x0.shape)}; got {x.dtype} {tuple(x.shape)}")
        if x.device != x0.device:
            raise NotImplementedError(
                f"rank {r} is on {x.device}, rank 0 on {x0.device}: a ring "
                "across devices comes with the multi-device slice")
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                "ring_psum has no gradient (nor has the JAX package's ring): "
                "call it under torch.no_grad(), or use the plain reduce")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0.device}")


def ring_psum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce sum of S rank buffers; S = 1 returns the input as is."""
    _check(parts)
    S = len(parts)
    if S == 1:
        return list(parts)
    x0 = parts[0]
    if x0.device.type == "cpu":
        return ring_psum_reference(parts)
    if S > MAX_RANKS:
        raise ValueError(f"the ring kernel takes at most {MAX_RANKS} ranks; got {S}")
    parts = [x.contiguous() for x in parts]
    n = x0.numel()
    out = torch.empty((S,) + tuple(x0.shape), dtype=torch.float32,
                      device=x0.device)
    ins = (ctypes.c_void_p * S)(*[x.data_ptr() for x in parts])
    outs = (ctypes.c_void_p * S)(*[out[r].data_ptr() for r in range(S)])
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = _kernel()(ins, outs, S, n, stream)
    if err:
        raise RuntimeError(f"hgnn2_ring_allreduce launch failed: CUDA error {err}")
    ring_psum.launches += 1
    return list(out.unbind(0))


ring_psum.launches = 0
