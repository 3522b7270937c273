"""Fused CCN promotion + contraction, forward and backward: wrappers of the
CUDA kernels in csrc/ccn_fused.cu (counterpart of
hgnn2_tpu/ops/pallas/ccn_fused.py).

  fused_contract_1d_forward  (K1) == contract_1d(promote_1d(chi_idx, nbr, f))
  fused_contract_1d_backward (K2) == promote_1d_bwd(contract_1d_transpose(g))
  fused_contract_forward     (K3) == contract_18(promote_2d(chi_idx, nbr, f),
                                                 deg, row_mask, compat)
  fused_contract_backward    (K4) == promote_2d_bwd(contract_18_transpose(g,
                                                 deg, row_mask, compat))

promote_contract_1d and promote_contract_18 pair K1 with K2 and K3 with K4
as torch.autograd.Functions (the JAX package's custom VJPs _op1d, _op).

For CUDA tensors each wrapper launches its kernel (one launch, on the
current stream) and adds one to its ``launches`` count; a kernel that
cannot run raises. For CPU tensors it runs the plain PyTorch version in
ops/contractions.py. The TPU kernels' lane layout and +-halo window do not
carry over: the CUDA kernels index neighbours directly, so there is no
limit on graph size, only K <= MAX_K.

The raw forward wrappers return a fresh tensor that the kernel fills, with
no autograd graph. So on CUDA they refuse an ``f`` that requires grad while
grad mode is on: a model that called them there would train each layer on
its own readout alone. Differentiable callers use the autograd Functions.
"""

from __future__ import annotations

import ctypes

import torch

from hgnn2_torch.ops import contractions, cuda_build

MAX_K = 8

# K3's tiles (csrc/ccn_fused.cu, ccn2d_forward): shared memory a block may
# take (4 blocks of 256 threads fit an H100 SM), and the most vertices a
# tile holds.
K3_SMEM_BYTES = 48 * 1024
K3_MAX_VT = 32
K3_CHANNELS = 18

# K1's, K2's and K4's blocks (ccn1d_forward, ccn1d_backward,
# ccn2d_backward): one thread per (vertex, slot, channel), at most this
# many a block.
K12_THREADS = 256
K4_THREADS = 128

# the kernels' C entries in csrc/ccn_fused.cu: (name, argtypes), for
# cuda_build.entry
_P, _I = ctypes.c_void_p, ctypes.c_int
_K1 = ("hgnn2_ccn1d_forward", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
_K2 = ("hgnn2_ccn1d_backward", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P])
_K3 = ("hgnn2_ccn2d_forward", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _P])
_K4 = ("hgnn2_ccn2d_backward", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _P])


def _k3_smem(K: int, vt: int, ct: int) -> int:
    """Bytes of shared memory of a K3 block of vt vertices and ct
    channels. Per vertex: its staged output (18 K^2 ct floats), its
    4K^2 + 4K + 4 reductions per channel, and its tables (chi, nbr,
    row_mask, deg)."""
    per_channel = K3_CHANNELS * K * K + 4 * K * K + 4 * K + 4
    return 4 * vt * (per_channel * ct + K * K + 2 * K + 1)


def _k3_tile(K: int, C: int) -> tuple[int, int, int]:
    """K3's tile (Vt vertices, Ct channels) and its shared-memory bytes.

    Ct = C with the largest even Vt <= K3_MAX_VT that fits
    K3_SMEM_BYTES: a vertex's output is 18 K^2 C floats, an even count,
    so with Vt even every tile starts 16-byte aligned and its output is
    one contiguous run. Where not even two vertices fit, one vertex a
    block and the channels split into tiles of at most half of C. The
    staged output fits shared memory, so a tile holds under 2^16 floats
    (the kernel's index range)."""
    fits = [vt for vt in range(2, K3_MAX_VT + 1, 2)
            if _k3_smem(K, vt, C) <= K3_SMEM_BYTES]
    if fits:
        return fits[-1], C, _k3_smem(K, fits[-1], C)
    per_channel = _k3_smem(K, 1, 1) - _k3_smem(K, 1, 0)
    ct = min(-(-C // 2), (K3_SMEM_BYTES - _k3_smem(K, 1, 0)) // per_channel)
    return 1, ct, _k3_smem(K, 1, ct)


def _slot_tile(K: int, C: int, threads: int,
               floats: int) -> tuple[int, int, int]:
    """The tile (Vt vertices, Ct channels) and shared-memory bytes of a
    kernel with one thread per (vertex, slot, channel) of its tile,
    Vt * K * Ct <= threads of them, each holding ``floats`` floats in
    shared memory. Ct = C unless K * C > threads: then the channels split
    over blocks, so there is no limit on C or V."""
    ct = min(C, threads // K)
    vt = threads // (K * ct)
    return vt, ct, 4 * vt * K * ct * floats


def _k12_tile(K: int, C: int) -> tuple[int, int, int]:
    """K1's and K2's tile: at most K12_THREADS threads a block, K floats a
    thread in shared memory (K1: the promoted T[v, k, :, c]; K2: slot k's
    share of df[v, :, c]), under 8 KB at any K."""
    return _slot_tile(K, C, K12_THREADS, K)


def _k4_tile(K: int, C: int) -> tuple[int, int, int]:
    """K4's tile: at most K4_THREADS threads a block, K^2 floats a thread
    in shared memory (slot k's share of df[v, :, :, c]), at most 32 KB."""
    return _slot_tile(K, C, K4_THREADS, K * K)


def _check(f: torch.Tensor, n_k_axes: int, **tensors) -> None:
    """Device, dtype, shape and contiguity checks shared by the wrappers.
    f is the (V, K[, K], C') feature or gradient tensor."""
    V, K = f.shape[0], f.shape[1]
    if K > MAX_K:
        raise ValueError(
            f"fused kernels unroll over K={K} > {MAX_K}; use the plain path "
            "for high-degree graphs")
    if f.dim() != 2 + n_k_axes or tuple(f.shape[1:1 + n_k_axes]) != (K,) * n_k_axes:
        raise ValueError(f"f must be (V{', K' * n_k_axes}, C); got {tuple(f.shape)}")
    if f.dtype != torch.float32:
        raise TypeError(f"f must be float32; got {f.dtype}")
    shapes = {"chi_idx": (V, K, K), "nbr": (V, K), "rslot": (V, K),
              "deg": (V,), "row_mask": (V, K)}
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}; got {tuple(t.shape)}")
        want = torch.float32 if name in ("deg", "row_mask") else torch.int32
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


def _check_no_grad(f: torch.Tensor, name: str) -> None:
    if f.device.type == "cuda" and torch.is_grad_enabled() and f.requires_grad:
        raise RuntimeError(
            f"{name} has no autograd graph: in grad mode use "
            "promote_contract_1d / promote_contract_18")


def fused_contract_1d_forward(chi_idx: torch.Tensor, nbr: torch.Tensor,
                              f: torch.Tensor) -> torch.Tensor:
    """contract_1d(promote_1d(chi_idx, nbr, f)) in one kernel (K1).
    chi_idx (V, K, K) int32, nbr (V, K) int32, f (V, K, C) float32.
    Returns (V, K, 2C): row sums then col sums on the channel axis."""
    V, K, C = f.shape
    _check(f, 1, chi_idx=chi_idx, nbr=nbr)
    if f.device.type == "cpu":
        return contractions.contract_1d(contractions.promote_1d(chi_idx, nbr, f))
    _check_no_grad(f, "fused_contract_1d_forward")
    out = torch.empty((V, K, 2 * C), dtype=torch.float32, device=f.device)
    cuda_build.launch(cuda_build.entry("ccn_fused", *_K1), f.device,
                      chi_idx.data_ptr(), nbr.data_ptr(), f.data_ptr(),
                      out.data_ptr(), V, K, C, *_k12_tile(K, C))
    fused_contract_1d_forward.launches += 1
    return out


fused_contract_1d_forward.launches = 0


def fused_contract_1d_backward(chi_idx: torch.Tensor, rslot: torch.Tensor,
                               nbr: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
    """df of the fused 1D op in one kernel (K2): g (V, K, 2C) float32 ->
    (V, K, C), df[u,p] = sum_j (g_row[nbr[u,j], chi[u,j,p]]
    + g_col[nbr[u,j], rslot[u,j]]) over valid (rslot, chi) entries."""
    g = g.contiguous()
    _check(g, 1, chi_idx=chi_idx, rslot=rslot, nbr=nbr)
    V, K, C2 = g.shape
    if C2 % 2:
        raise ValueError(f"g must be (V, K, 2C); got {tuple(g.shape)}")
    if g.device.type == "cpu":
        return contractions.promote_1d_bwd(
            chi_idx, rslot, nbr, contractions.contract_1d_transpose(g))
    df = torch.empty((V, K, C2 // 2), dtype=torch.float32, device=g.device)
    cuda_build.launch(cuda_build.entry("ccn_fused", *_K2), g.device,
                      chi_idx.data_ptr(), rslot.data_ptr(), nbr.data_ptr(),
                      g.data_ptr(), df.data_ptr(), V, K, C2 // 2,
                      *_k12_tile(K, C2 // 2))
    fused_contract_1d_backward.launches += 1
    return df


fused_contract_1d_backward.launches = 0


def fused_contract_forward(chi_idx: torch.Tensor, nbr: torch.Tensor,
                           f: torch.Tensor, deg: torch.Tensor,
                           row_mask: torch.Tensor,
                           compat: bool = False) -> torch.Tensor:
    """contract_18(promote_2d(chi_idx, nbr, f), deg, row_mask, compat) in
    one kernel (K3); the (V, K, K, K, C) promotion tensor is never written.
    f (V, K, K, C) float32, deg (V,) float32, row_mask (V, K) float32.
    Returns (V, K, K, 18C), channel index block * C + c."""
    V, K = f.shape[0], f.shape[1]
    C = f.shape[-1]
    _check(f, 2, chi_idx=chi_idx, nbr=nbr, deg=deg, row_mask=row_mask)
    if f.device.type == "cpu":
        return contractions.contract_18(
            contractions.promote_2d(chi_idx, nbr, f), deg, row_mask,
            compat=compat)
    _check_no_grad(f, "fused_contract_forward")
    out = torch.empty((V, K, K, 18 * C), dtype=torch.float32, device=f.device)
    cuda_build.launch(cuda_build.entry("ccn_fused", *_K3), f.device,
                      chi_idx.data_ptr(), nbr.data_ptr(), f.data_ptr(),
                      deg.data_ptr(), row_mask.data_ptr(), out.data_ptr(),
                      V, K, C, int(compat), *_k3_tile(K, C))
    fused_contract_forward.launches += 1
    return out


fused_contract_forward.launches = 0


def fused_contract_backward(chi_idx: torch.Tensor, rslot: torch.Tensor,
                            nbr: torch.Tensor, g: torch.Tensor,
                            deg: torch.Tensor, row_mask: torch.Tensor,
                            compat: bool = False) -> torch.Tensor:
    """df of the fused 2D op in one kernel (K4): g (V, K, K, 18C) float32
    -> (V, K, K, C), df[u,p,q] = sum_j over valid slots of
    gbar[nbr[u,j], rslot[u,j], chi[u,j,p], chi[u,j,q]] with gbar the
    adjoint of contract_18 applied to g. The kernel forms each
    neighbour's share of the adjoint from g where it needs it, so neither
    the four (V, K, K, C) parts of contract_18_transpose_parts nor the
    (V, K, K, K, C) gbar is written, and sums in the plain version's
    order: the two agree bit for bit."""
    g = g.contiguous()
    if g.dim() != 4 or g.shape[-1] % 18:
        raise ValueError(f"g must be (V, K, K, 18C); got {tuple(g.shape)}")
    _check(g, 2, chi_idx=chi_idx, rslot=rslot, nbr=nbr, deg=deg,
           row_mask=row_mask)
    V, K, C = g.shape[0], g.shape[1], g.shape[-1] // 18
    if g.device.type == "cpu":
        return contractions.promote_2d_bwd(
            chi_idx, rslot, nbr,
            contractions.contract_18_transpose(g, deg, row_mask, compat=compat))
    df = torch.empty((V, K, K, C), dtype=torch.float32, device=g.device)
    cuda_build.launch(cuda_build.entry("ccn_fused", *_K4), g.device,
                      chi_idx.data_ptr(), rslot.data_ptr(), nbr.data_ptr(),
                      g.data_ptr(), deg.data_ptr(), row_mask.data_ptr(),
                      df.data_ptr(), V, K, C, int(compat), *_k4_tile(K, C))
    fused_contract_backward.launches += 1
    return df


fused_contract_backward.launches = 0


class _PromoteContract1D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chi_idx, nbr, f, rslot):
        # the output is linear in f, so only the index tables are saved
        ctx.save_for_backward(chi_idx, rslot, nbr)
        return fused_contract_1d_forward(chi_idx, nbr, f)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        df = None
        if ctx.needs_input_grad[2]:
            df = fused_contract_1d_backward(*ctx.saved_tensors, g)
        return None, None, df, None


class _PromoteContract18(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chi_idx, nbr, f, deg, row_mask, rslot, compat):
        ctx.save_for_backward(chi_idx, rslot, nbr, deg, row_mask)
        ctx.compat = compat
        return fused_contract_forward(chi_idx, nbr, f, deg, row_mask,
                                      compat=compat)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        df = None
        if ctx.needs_input_grad[2]:
            chi_idx, rslot, nbr, deg, row_mask = ctx.saved_tensors
            df = fused_contract_backward(chi_idx, rslot, nbr, g, deg,
                                         row_mask, compat=ctx.compat)
        return None, None, df, None, None, None, None


def promote_contract_1d(chi_idx: torch.Tensor, nbr: torch.Tensor,
                        f: torch.Tensor, rslot: torch.Tensor) -> torch.Tensor:
    """Differentiable fused CCN-1D promotion + contraction: K1 forward, K2
    backward. Equals contract_1d(promote_1d(chi_idx, nbr, f, rslot=rslot))."""
    return _PromoteContract1D.apply(chi_idx, nbr, f, rslot)


def promote_contract_18(chi_idx: torch.Tensor, nbr: torch.Tensor,
                        f: torch.Tensor, deg: torch.Tensor,
                        row_mask: torch.Tensor, rslot: torch.Tensor,
                        compat: bool = False) -> torch.Tensor:
    """Differentiable fused promotion + 18 contractions: K3 forward, K4
    backward. Equals
    contract_18(promote_2d(chi_idx, nbr, f, rslot=rslot), deg, row_mask)."""
    return _PromoteContract18.apply(chi_idx, nbr, f, deg, row_mask, rslot,
                                    compat)


def use_kernel(k_max: int, device: str | torch.device) -> bool:
    """Whether the CCN models should run the fused kernels: on CUDA, for
    K <= MAX_K. (The TPU rule at hgnn2_tpu/cli/common.py:273-282 also
    required every graph to fit its +-128-row halo window; the CUDA kernels
    load neighbours by index and have no such limit.)"""
    return torch.device(device).type == "cuda" and k_max <= MAX_K
