"""Fused CCN promotion + contraction forward: wrappers of the CUDA kernels
in csrc/ccn_fused.cu (counterpart of hgnn2_tpu/ops/pallas/ccn_fused.py).

  fused_contract_1d_forward == contract_1d(promote_1d(chi_idx, nbr, f))
  fused_contract_forward    == contract_18(promote_2d(chi_idx, nbr, f),
                                           deg, row_mask, compat)

For CUDA tensors each wrapper launches its kernel (one launch, on the
current stream) and adds one to its ``launches`` count; a kernel that
cannot run raises. For CPU tensors it runs the plain PyTorch version in
ops/contractions.py. The TPU kernels' lane layout and +-halo window do not
carry over: the CUDA kernels index neighbours directly, so there is no
limit on graph size, only K <= MAX_K. The backward kernels come with the
training slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hgnn2_torch.ops import contractions, cuda_build

MAX_K = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "hgnn2_ccn1d_forward": [_P, _P, _P, _P, _I, _I, _I, _P],
    "hgnn2_ccn2d_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


@functools.cache
def _kernel(name: str):
    fn = getattr(cuda_build.load("ccn_fused"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(f: torch.Tensor, n_k_axes: int, **tensors) -> None:
    """Device, dtype, shape and contiguity checks shared by both wrappers."""
    V, K = f.shape[0], f.shape[1]
    if f.dim() != 2 + n_k_axes or tuple(f.shape[1:1 + n_k_axes]) != (K,) * n_k_axes:
        raise ValueError(f"f must be (V{', K' * n_k_axes}, C); got {tuple(f.shape)}")
    if f.dtype != torch.float32:
        raise TypeError(f"f must be float32; got {f.dtype}")
    shapes = {"chi_idx": (V, K, K), "nbr": (V, K), "deg": (V,),
              "row_mask": (V, K)}
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}; got {tuple(t.shape)}")
        want = torch.int32 if name in ("chi_idx", "nbr") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}; got {t.dtype}")
        if t.device != f.device:
            raise ValueError(f"{name} is on {t.device}, f on {f.device}")
    if f.device.type == "cuda":
        for name, t in [("f", f), *tensors.items()]:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    elif f.device.type != "cpu":
        raise ValueError(f"unsupported device {f.device}")


def _launch(name: str, f: torch.Tensor, *args) -> None:
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = _kernel(name)(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def fused_contract_1d_forward(chi_idx: torch.Tensor, nbr: torch.Tensor,
                              f: torch.Tensor) -> torch.Tensor:
    """contract_1d(promote_1d(chi_idx, nbr, f)) in one kernel.
    chi_idx (V, K, K) int32, nbr (V, K) int32, f (V, K, C) float32.
    Returns (V, K, 2C): row sums then col sums on the channel axis."""
    V, K, C = f.shape
    if K > MAX_K:
        raise ValueError(
            f"fused 1D kernel unrolls over K={K} > {MAX_K}; use the plain "
            "path for high-degree graphs")
    _check(f, 1, chi_idx=chi_idx, nbr=nbr)
    if f.device.type == "cpu":
        return contractions.contract_1d(contractions.promote_1d(chi_idx, nbr, f))
    out = torch.empty((V, K, 2 * C), dtype=torch.float32, device=f.device)
    _launch("hgnn2_ccn1d_forward", f, chi_idx.data_ptr(), nbr.data_ptr(),
            f.data_ptr(), out.data_ptr(), V, K, C)
    fused_contract_1d_forward.launches += 1
    return out


fused_contract_1d_forward.launches = 0


def fused_contract_forward(chi_idx: torch.Tensor, nbr: torch.Tensor,
                           f: torch.Tensor, deg: torch.Tensor,
                           row_mask: torch.Tensor,
                           compat: bool = False) -> torch.Tensor:
    """contract_18(promote_2d(chi_idx, nbr, f), deg, row_mask, compat) in
    one kernel; the (V, K, K, K, C) promotion tensor is never written.
    f (V, K, K, C) float32, deg (V,) float32, row_mask (V, K) float32.
    Returns (V, K, K, 18C), channel index block * C + c."""
    V, K = f.shape[0], f.shape[1]
    C = f.shape[-1]
    if K > MAX_K:
        raise ValueError(
            f"fused kernel unrolls over K={K} > {MAX_K}; use the scan path "
            "for high-degree graphs")
    _check(f, 2, chi_idx=chi_idx, nbr=nbr, deg=deg, row_mask=row_mask)
    if f.device.type == "cpu":
        return contractions.contract_18(
            contractions.promote_2d(chi_idx, nbr, f), deg, row_mask,
            compat=compat)
    out = torch.empty((V, K, K, 18 * C), dtype=torch.float32, device=f.device)
    _launch("hgnn2_ccn2d_forward", f, chi_idx.data_ptr(), nbr.data_ptr(),
            f.data_ptr(), deg.data_ptr(), row_mask.data_ptr(), out.data_ptr(),
            V, K, C, int(compat))
    fused_contract_forward.launches += 1
    return out


fused_contract_forward.launches = 0


def use_kernel(k_max: int, device: str | torch.device) -> bool:
    """Whether the CCN models should run the fused kernels: on CUDA, for
    K <= MAX_K. (The TPU rule at hgnn2_tpu/cli/common.py:273-282 also
    required every graph to fit its +-128-row halo window; the CUDA kernels
    load neighbours by index and have no such limit.)"""
    return torch.device(device).type == "cuda" and k_max <= MAX_K
