"""The padding-aware batch norm's train-mode forward and backward as one CUDA
kernel each: wrappers of csrc/bn_fused.cu, joined by a
torch.autograd.Function, for nn/layers.py:MaskedBatchNorm.

  bn_forward  == composed(h, m, ...) in train mode: the output, and the
                 batch's mean, std and count; the running buffers updated
  bn_backward == backward_reference(g, h, m, scale, mean, std, count, ...)

The JAX package has no kernel here (XLA fuses the batch norm on the TPU);
on the H100 the composed PyTorch ops are some 53 launches a batch norm,
forward and backward, and the GNN step is launch-bound.

For CUDA tensors each wrapper launches its kernel (one launch, on the
current stream) and adds one to its ``launches`` count; a kernel that
cannot run raises. For CPU tensors it runs the plain PyTorch version:
``composed``, the batch norm as PyTorch ops (the path MaskedBatchNorm
takes everywhere else), and ``backward_reference``, its gradient written
out as formulas.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hgnn2_torch.ops import cuda_build

# the kernels' C entries in csrc/bn_fused.cu: (name, argtypes), for
# cuda_build.entry
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_INIT = ("hgnn2_bn_init", [])
_FORWARD = ("hgnn2_bn_forward", [_P] * 8 + [_I] * 4 + [_F] * 3 + [_P])
_BACKWARD = ("hgnn2_bn_backward", [_P] * 8 + [_I] * 4 + [_P])


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def use_kernel(device: torch.device, dtype: torch.dtype, training: bool,
               axis_name) -> bool:
    """Whether MaskedBatchNorm takes the kernels: in train mode, on CUDA, in
    float32, with statistics of its own input (no axis_name: pooled
    statistics need the psum between the two passes). Eval mode, float64,
    the CPU and pooled statistics take ``composed``."""
    return (training and axis_name is None and dtype == torch.float32
            and torch.device(device).type == "cuda")


def composed(h: torch.Tensor, m: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor, run_mean: torch.Tensor, run_std: torch.Tensor,
             momentum: float, eps: float, mask_out: bool, training: bool = True,
             psum=_same):
    """The batch norm as PyTorch ops: h (..., F), m (...) in h's dtype.
    In train mode one masked mean and std per feature over every valid
    position (count, then the sum, then the squared deviations about the
    mean; psum pools each sum over ranks), the running buffers updated in
    place; in eval mode the running statistics. Returns the output, and
    in train mode the batch's (mean, std, count), else None."""
    mc = m[..., None]
    hm = h * mc
    batch = None
    if training:
        axes = tuple(range(h.dim() - 1))
        count = psum(mc.sum()).clamp_min(1.0)
        mean = psum(hm.sum(dim=axes)) / count
        sq = psum((((hm - mean) * mc) ** 2).sum(dim=axes))
        std = torch.sqrt(eps + sq / count)
        with torch.no_grad():
            run_mean.copy_((1.0 - momentum) * mean + momentum * run_mean)
            run_std.copy_((1.0 - momentum) * std + momentum * run_std)
        batch = (mean, std, count)
    else:
        mean, std = run_mean, run_std
    out = scale * ((hm - mean) / std) + bias
    if mask_out:
        out = out * mc
    return out, batch


def backward_reference(g: torch.Tensor, h: torch.Tensor, m: torch.Tensor,
                       scale: torch.Tensor, mean: torch.Tensor,
                       std: torch.Tensor, count: torch.Tensor,
                       mask_out: bool):
    """The train-mode gradient of ``composed`` as formulas: g the output's
    gradient, (mean, std, count) the forward's batch statistics. With
    d = h m - mean and gm = g m (g when not mask_out), per feature
    P = sum gm, Q = sum gm d and C = sum d m^2:
      g_bias = P, g_scale = Q / std (summed over features for a 0-d scale)
      g_h = (a gm - b d m^2 - k) m, a = scale / std,
      b = scale Q / (std^3 count), k = (scale P / std - b C) / count
    (b and the C term are the std's path, k the mean's.)"""
    mc = m[..., None]
    axes = tuple(range(h.dim() - 1))
    d = h * mc - mean
    gm = g * mc if mask_out else g
    P = gm.sum(dim=axes)
    Q = (gm * d).sum(dim=axes)
    C = (d * mc * mc).sum(dim=axes)
    a = scale / std
    b = scale * Q / (std * std * std * count)
    k = (scale * P / std - b * C) / count
    g_h = (a * gm - b * d * mc * mc - k) * mc
    g_scale, g_bias = Q / std, P
    if scale.dim() == 0:
        g_scale, g_bias = g_scale.sum(), g_bias.sum()
    return g_h, g_scale, g_bias


@functools.cache
def _init(device: torch.device) -> None:
    """The library's hgnn2_bn_init, once a device, before its first
    launch there."""
    with torch.cuda.device(device):
        cuda_build.check(cuda_build.entry("bn_fused", *_INIT)(),
                         "hgnn2_bn_init")


def _check(h: torch.Tensor, m: torch.Tensor, scale: torch.Tensor,
           **features) -> None:
    """Device, dtype, shape and contiguity checks shared by the wrappers:
    h (..., F), m h.shape[:-1], scale (F,) or (), each of ``features``
    (F,) or, where marked 'affine', scale's shape."""
    F = h.shape[-1] if h.dim() else 0
    if h.dim() < 1 or F < 1:
        raise ValueError(f"h must be (..., F) with F >= 1; got {tuple(h.shape)}")
    if tuple(m.shape) != tuple(h.shape[:-1]):
        raise ValueError(f"mask must be {tuple(h.shape[:-1])}; got {tuple(m.shape)}")
    if tuple(scale.shape) not in ((), (F,)):
        raise ValueError(f"scale must be () or ({F},); got {tuple(scale.shape)}")
    want = {"affine": tuple(scale.shape), "feature": (F,), "stats": (2 * F + 1,),
            "rows": tuple(h.shape)}
    tensors = {"h": h, "mask": m, "scale": scale}
    for name, (kind, t) in features.items():
        if tuple(t.shape) != want[kind]:
            raise ValueError(f"{name} must be {want[kind]}; got {tuple(t.shape)}")
        tensors[name] = t
    for name, t in tensors.items():
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if t.dtype != h.dtype:
            raise TypeError(f"{name} is {t.dtype}, h {h.dtype}")
    if h.device.type == "cuda":
        if h.dtype != torch.float32:
            raise TypeError(f"the kernels take float32; got {h.dtype}")
        for name, t in tensors.items():
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    elif h.device.type != "cpu":
        raise ValueError(f"unsupported device {h.device}")


def bn_forward(h: torch.Tensor, m: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, run_mean: torch.Tensor,
               run_std: torch.Tensor, momentum: float, eps: float,
               mask_out: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The train-mode batch norm in one kernel: h (..., F) float32, m
    h.shape[:-1] (the mask in h's dtype), scale and bias (F,) or (); the
    running buffers (F,) are updated in place. Returns the output and the
    statistics (2F + 1,): the batch mean, std, then the clamped count."""
    _check(h, m, scale, bias=("affine", bias), run_mean=("feature", run_mean),
           run_std=("feature", run_std))
    F = h.shape[-1]
    if h.device.type == "cpu":
        out, (mean, std, count) = composed(h, m, scale, bias, run_mean, run_std,
                                           momentum, eps, mask_out)
        return out, torch.cat([mean, std, count.reshape(1)])
    out = torch.empty_like(h)
    stats = torch.empty(2 * F + 1, dtype=h.dtype, device=h.device)
    _init(h.device)
    cuda_build.launch(cuda_build.entry("bn_fused", *_FORWARD), h.device,
                      h.data_ptr(), m.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
                      run_mean.data_ptr(), run_std.data_ptr(), h.numel() // F,
                      F, int(scale.dim() == 0), int(mask_out), eps,
                      1.0 - momentum, momentum)
    bn_forward.launches += 1
    return out, stats


bn_forward.launches = 0


def bn_backward(g: torch.Tensor, h: torch.Tensor, m: torch.Tensor,
                scale: torch.Tensor, stats: torch.Tensor,
                mask_out: bool) -> tuple[torch.Tensor, ...]:
    """The train-mode batch norm's gradient in one kernel: g the output's
    gradient, h, m and scale the forward's inputs, stats its statistics
    (bn_forward). Returns g_h, g_scale and g_bias (scale's shape)."""
    _check(h, m, scale, g=("rows", g), stats=("stats", stats))
    F = h.shape[-1]
    if h.device.type == "cpu":
        return backward_reference(g, h, m, scale, stats[:F], stats[F:2 * F],
                                  stats[2 * F], mask_out)
    g_h = torch.empty_like(h)
    g_scale, g_bias = torch.empty_like(scale), torch.empty_like(scale)
    _init(h.device)
    cuda_build.launch(cuda_build.entry("bn_fused", *_BACKWARD), h.device,
                      g.data_ptr(), h.data_ptr(), m.data_ptr(),
                      scale.data_ptr(), stats.data_ptr(), g_h.data_ptr(),
                      g_scale.data_ptr(), g_bias.data_ptr(), h.numel() // F,
                      F, int(scale.dim() == 0), int(mask_out))
    bn_backward.launches += 1
    return g_h, g_scale, g_bias


bn_backward.launches = 0


class _MaskedBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, m, scale, bias, run_mean, run_std, momentum, eps,
                mask_out):
        out, stats = bn_forward(h, m, scale, bias, run_mean, run_std,
                                momentum, eps, mask_out)
        ctx.save_for_backward(h, m, scale, stats)
        ctx.mask_out = mask_out
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, m, scale, stats = ctx.saved_tensors
        g_h, g_scale, g_bias = bn_backward(g.contiguous(), h, m, scale, stats,
                                           ctx.mask_out)
        return g_h, None, g_scale, g_bias, None, None, None, None, None


def masked_batch_norm(h: torch.Tensor, m: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, run_mean: torch.Tensor,
                      run_std: torch.Tensor, momentum: float, eps: float,
                      mask_out: bool) -> torch.Tensor:
    """Differentiable train-mode batch norm: bn_forward forward,
    bn_backward backward. Equals composed(...)[0] up to the order of its
    sums; h and m are made contiguous."""
    return _MaskedBatchNorm.apply(h.contiguous(), m.contiguous(), scale, bias,
                                  run_mean, run_std, momentum, eps, mask_out)
