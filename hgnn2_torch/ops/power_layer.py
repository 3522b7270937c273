"""GNNSimple's power layer in train mode as one CUDA kernel each way:
wrappers of csrc/power_layer.cu, joined by a torch.autograd.Function, for
nn/layers.py:PowerLayer.

  power_forward  == composed(x, adj_powers, ...) in train mode: the
                    output, the ReLUs' output z (the batch norm's input)
                    and the batch statistics; the running buffers updated
  power_backward == backward_reference(g, x, adj_powers, ..., z, stats)

The layer is graph_op (ops/dense.py), the two convolutions and their ReLUs
concatenated (nn/layers.py:pair_conv) and MaskedBatchNorm's train-mode
batch norm (ops/bn_fused.py). The JAX package has no kernel here (XLA
fuses the layer on the TPU); on the H100 the composed PyTorch ops are
about 34 launches a layer, forward and backward, and the GNN step is
launch-bound.

For CUDA tensors each wrapper launches its kernel (one launch, on the
current stream) and adds one to its ``launches`` count; a kernel that
cannot run raises. For CPU tensors it runs the plain PyTorch version:
``composed``, PowerLayer's arithmetic as PyTorch ops (the path PowerLayer
takes everywhere else), and ``backward_reference``, its gradient written
out as formulas.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from hgnn2_torch.ops import bn_fused, cuda_build
from hgnn2_torch.ops import dense as D

# the kernels' C entries in csrc/power_layer.cu: (name, argtypes), for
# cuda_build.entry
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_INIT = ("hgnn2_power_init", [])
_FORWARD = ("hgnn2_power_forward", [_P] * 17 + [_I] * 7 + [_F] * 3 + [_P])
_BACKWARD = ("hgnn2_power_backward", [_P] * 19 + [_I] * 7 + [_P])

# the instantiated (input width Fi, J, output width 2H) of csrc/power_layer.cu
KERNEL_SHAPES = frozenset((fi, J, h2) for fi in (2, 4, 5) for J in (1, 2)
                          for h2 in (2, 4))
MAX_N = 32  # node slots a graph; a multiple of 4
THREADS = 256  # a block's threads: one a node slot of a chunk of graphs
CTAS = 16  # the blocks of a cluster
MAX_CLUSTERS = 8  # the clusters of a launch
MAX_BLOCK_ROWS = 4096  # rows of the gradient a block keeps in shared memory
MAX_ROWS = 16 * CTAS * THREADS  # B N: 16 rows a thread of one cluster


def clusters(B: int, N: int) -> int:
    """The clusters of a launch over B graphs of N slots: enough for one
    chunk of THREADS // N graphs a block, at most MAX_CLUSTERS (as
    csrc/power_layer.cu:clusters_for)."""
    per_cluster = CTAS * (THREADS // N)
    return max(1, min(MAX_CLUSTERS, -(-B // per_cluster)))


def fits(B: int, N: int, fi: int, J: int, h2: int) -> bool:
    """Whether the kernels take B graphs of N node slots, input width fi,
    J adjacency powers and output width h2 (= 2 features_out)."""
    if ((fi, J, h2) not in KERNEL_SHAPES or not 4 <= N <= MAX_N or N % 4
            or B < 1):
        return False
    return (B * N <= MAX_ROWS
            and -(-B // (CTAS * clusters(B, N))) * N <= MAX_BLOCK_ROWS)


def use_kernel(x: torch.Tensor, adj_powers: torch.Tensor | None,
               features_out: int, training: bool, dtype, axis_name,
               gru: bool) -> bool:
    """Whether PowerLayer takes the kernels: in train mode, on CUDA, in
    float32 (no compute dtype), with statistics of its own input (no
    bn_axis), without the GRU, over a dense bundle's adjacency powers
    (adj_powers None otherwise) that need no gradient, at a shape inside
    the kernels' caps (fits). Eval mode, bf16, float64, the CPU, pooled
    statistics, the GRU and larger shapes take the composition."""
    if (not training or dtype is not None or axis_name is not None or gru
            or adj_powers is None or x.device.type != "cuda"
            or x.dtype != torch.float32 or adj_powers.dtype != torch.float32
            or adj_powers.requires_grad or x.dim() != 3):
        return False
    B, N, fi = x.shape
    return fits(B, N, fi, adj_powers.shape[1], 2 * features_out)


def composed(x: torch.Tensor, adj_powers: torch.Tensor, deg: torch.Tensor,
             node_mask: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor,
             b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
             scale: torch.Tensor, bias: torch.Tensor, run_mean: torch.Tensor,
             run_std: torch.Tensor, momentum: float, eps: float,
             mask_out: bool, training: bool = True):
    """PowerLayer's arithmetic (no GRU, no compute dtype) as PyTorch ops:
    x1 = graph_op(x), z = [relu(cv2(x1)) | relu(cv1(x1))], then the batch
    norm of z over ``mask`` (bn_fused.composed; in train mode the running
    buffers are updated in place). Returns the output, z and, in train
    mode, the batch's (mean, std, count), else None."""
    x1 = D.graph_op(adj_powers, deg, x, node_mask)
    a = torch.relu(F.linear(x1, w1, b1))
    b = torch.relu(F.linear(x1, w2, b2))
    z = torch.cat([b, a], dim=-1)
    h = z.to(torch.promote_types(z.dtype, torch.float32))
    out, batch = bn_fused.composed(h, mask.to(h.dtype), scale, bias, run_mean,
                                   run_std, momentum, eps, mask_out,
                                   training=training)
    return out, z, batch


def backward_reference(g: torch.Tensor, x: torch.Tensor,
                       adj_powers: torch.Tensor, deg: torch.Tensor,
                       node_mask: torch.Tensor, mask: torch.Tensor,
                       w1: torch.Tensor, w2: torch.Tensor,
                       scale: torch.Tensor, z: torch.Tensor,
                       stats: torch.Tensor, mask_out: bool):
    """The train-mode gradient of ``composed`` as formulas: g the output's
    gradient, z and stats (mean, std, count) the forward's. The batch
    norm's gradient g_z (bn_fused.backward_reference), the ReLUs' gate
    gp = g_z where z > 0, split into cv2's and cv1's columns; then with
    x1 = graph_op(x) and blocks [x m_id | deg x | A_j x ...] of width Fi:
      g_w = sum gp^T x1, g_b = sum gp (over every row),
      dx1 = gp1 W1 + gp2 W2,
      dx = m_id dx1[blk 0] + deg dx1[blk 1] + sum_j A_j^T dx1[blk j + 2]
    (A_j^T within each graph). Returns dx, g_w1, g_b1, g_w2, g_b2,
    g_scale and g_bias."""
    h2 = z.shape[-1]
    H = h2 // 2
    g_z, g_scale, g_bias = bn_fused.backward_reference(
        g, z, mask.to(z.dtype), scale, stats[:h2], stats[h2:2 * h2],
        stats[2 * h2], mask_out)
    gp = torch.where(z <= 0, torch.zeros_like(g_z), g_z)
    gp2, gp1 = gp[..., :H], gp[..., H:]
    x1 = D.graph_op(adj_powers, deg, x, node_mask)
    g_w1 = torch.einsum("bnh,bnk->hk", gp1, x1)
    g_w2 = torch.einsum("bnh,bnk->hk", gp2, x1)
    g_b1, g_b2 = gp1.sum(dim=(0, 1)), gp2.sum(dim=(0, 1))
    B, N, fi = x.shape
    J = adj_powers.shape[1]
    dx1 = (gp1 @ w1 + gp2 @ w2).reshape(B, N, J + 2, fi)
    dx = (dx1[:, :, 0] * node_mask.to(x.dtype)[..., None]
          + dx1[:, :, 1] * deg[..., None]
          + torch.einsum("bjnm,bnjf->bmf", adj_powers, dx1[:, :, 2:]))
    return dx, g_w1, g_b1, g_w2, g_b2, g_scale, g_bias


@functools.cache
def _init(device: torch.device) -> None:
    """The library's hgnn2_power_init, once a device, before its first
    launch there."""
    with torch.cuda.device(device):
        cuda_build.check(cuda_build.entry("power_layer", *_INIT)(),
                         "hgnn2_power_init")


def _check(x: torch.Tensor, adj_powers: torch.Tensor, w1: torch.Tensor,
           scale: torch.Tensor, **tensors) -> tuple[int, ...]:
    """Device, dtype, shape and contiguity checks shared by the wrappers:
    x (B, N, Fi), adj_powers (B, J, N, N), w1 (H, K = (J + 2) Fi); each of
    ``tensors`` (kind, tensor), its shape given by the kind. Returns
    (B, N, Fi, J, 2H)."""
    if x.dim() != 3 or adj_powers.dim() != 4:
        raise ValueError(f"x must be (B, N, Fi) and adj_powers (B, J, N, N); "
                         f"got {tuple(x.shape)}, {tuple(adj_powers.shape)}")
    B, N, fi = x.shape
    J = adj_powers.shape[1]
    if tuple(adj_powers.shape) != (B, J, N, N):
        raise ValueError(f"adj_powers must be {(B, J, N, N)}; got "
                         f"{tuple(adj_powers.shape)}")
    if w1.dim() != 2 or w1.shape[1] != (J + 2) * fi:
        raise ValueError(f"w1 must be (H, {(J + 2) * fi}); got "
                         f"{tuple(w1.shape)}")
    H = w1.shape[0]
    if tuple(scale.shape) not in ((), (2 * H,)):
        raise ValueError(f"scale must be () or ({2 * H},); got "
                         f"{tuple(scale.shape)}")
    want = {"rows": (B, N), "weight": tuple(w1.shape), "unit": (H,),
            "affine": tuple(scale.shape), "feature": (2 * H,),
            "out": (B, N, 2 * H), "stats": (4 * H + 1,), "x": (B, N, fi)}
    checked = {"x": x, "adj_powers": adj_powers, "w1": w1, "scale": scale}
    for name, (kind, t) in tensors.items():
        if tuple(t.shape) != want[kind]:
            raise ValueError(f"{name} must be {want[kind]}; got "
                             f"{tuple(t.shape)}")
        checked[name] = t
    for name, t in checked.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x {x.dtype}")
    if x.device.type == "cuda":
        if x.dtype != torch.float32:
            raise TypeError(f"the kernels take float32; got {x.dtype}")
        for name, t in checked.items():
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if not fits(B, N, fi, J, 2 * H):
            raise ValueError(f"no kernel for B={B}, N={N}, Fi={fi}, J={J}, "
                             f"H={H} (power_layer.fits)")
        if adj_powers.data_ptr() % 16:
            raise ValueError("adj_powers must be 16-byte aligned")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return B, N, fi, J, 2 * H


def power_forward(x: torch.Tensor, adj_powers: torch.Tensor,
                  deg: torch.Tensor, node_mask: torch.Tensor,
                  mask: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, run_mean: torch.Tensor,
                  run_std: torch.Tensor, momentum: float, eps: float,
                  mask_out: bool):
    """The train-mode power layer in one kernel: x (B, N, Fi) float32,
    adj_powers (B, J, N, N), deg, node_mask (graph_op's) and mask (the
    batch norm's) (B, N) in x's dtype, cv1's and cv2's weights (H, K) and
    biases (H,), the batch norm's scale and bias (2H,) or (); the running
    buffers (2H,) are updated in place. Returns the output (B, N, 2H), z
    (the ReLUs' output, the batch norm's input) and the statistics
    (4H + 1,): the batch mean, std, then the clamped count."""
    B, N, fi, J, h2 = _check(
        x, adj_powers, w1, scale, deg=("rows", deg),
        node_mask=("rows", node_mask), mask=("rows", mask),
        b1=("unit", b1), w2=("weight", w2), b2=("unit", b2),
        bias=("affine", bias), run_mean=("feature", run_mean),
        run_std=("feature", run_std))
    if x.device.type == "cpu":
        out, z, (mean, std, count) = composed(
            x, adj_powers, deg, node_mask, mask, w1, b1, w2, b2, scale, bias,
            run_mean, run_std, momentum, eps, mask_out)
        return out, z, torch.cat([mean, std, count.reshape(1)])
    out = torch.empty(B, N, h2, dtype=x.dtype, device=x.device)
    z = torch.empty_like(out)
    stats = torch.empty(2 * h2 + 1, dtype=x.dtype, device=x.device)
    parts = torch.empty(clusters(B, N) * (h2 + 1), dtype=x.dtype,
                        device=x.device)
    _init(x.device)
    cuda_build.launch(cuda_build.entry("power_layer", *_FORWARD), x.device,
                      x.data_ptr(), adj_powers.data_ptr(), deg.data_ptr(),
                      node_mask.data_ptr(), mask.data_ptr(), w1.data_ptr(),
                      b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                      scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                      z.data_ptr(), stats.data_ptr(), run_mean.data_ptr(),
                      run_std.data_ptr(), parts.data_ptr(), B, N, fi, J, h2,
                      int(scale.dim() == 0), int(mask_out), eps,
                      1.0 - momentum, momentum)
    power_forward.launches += 1
    return out, z, stats


power_forward.launches = 0


def power_backward(g: torch.Tensor, x: torch.Tensor, adj_powers: torch.Tensor,
                   deg: torch.Tensor, node_mask: torch.Tensor,
                   mask: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   scale: torch.Tensor, z: torch.Tensor, stats: torch.Tensor,
                   mask_out: bool, need_dx: bool = True):
    """The train-mode power layer's gradient in one kernel: g the output's
    gradient, x ... scale the forward's inputs, z and stats its saved
    tensors (power_forward). Returns dx (None unless need_dx), g_w1,
    g_b1, g_w2, g_b2, g_scale and g_bias (scale's shape)."""
    B, N, fi, J, h2 = _check(
        x, adj_powers, w1, scale, g=("out", g), deg=("rows", deg),
        node_mask=("rows", node_mask), mask=("rows", mask),
        w2=("weight", w2), z=("out", z), stats=("stats", stats))
    if x.device.type == "cpu":
        dx, *rest = backward_reference(g, x, adj_powers, deg, node_mask, mask,
                                       w1, w2, scale, z, stats, mask_out)
        return (dx if need_dx else None, *rest)
    dx = torch.empty_like(x) if need_dx else None
    g_w1, g_w2 = torch.empty_like(w1), torch.empty_like(w2)
    g_b1 = torch.empty(h2 // 2, dtype=x.dtype, device=x.device)
    g_b2 = torch.empty_like(g_b1)
    g_scale, g_bias = torch.empty_like(scale), torch.empty_like(scale)
    parts = torch.empty(CTAS * clusters(B, N) * h2 * (w1.shape[1] + 1),
                        dtype=x.dtype, device=x.device)
    _init(x.device)
    cuda_build.launch(cuda_build.entry("power_layer", *_BACKWARD), x.device,
                      g.data_ptr(), x.data_ptr(), adj_powers.data_ptr(),
                      deg.data_ptr(), node_mask.data_ptr(), mask.data_ptr(),
                      w1.data_ptr(), w2.data_ptr(), scale.data_ptr(),
                      z.data_ptr(), stats.data_ptr(),
                      dx.data_ptr() if need_dx else None, g_w1.data_ptr(),
                      g_b1.data_ptr(), g_w2.data_ptr(), g_b2.data_ptr(),
                      g_scale.data_ptr(), g_bias.data_ptr(), parts.data_ptr(),
                      B, N, fi, J, h2,
                      int(scale.dim() == 0), int(mask_out))
    power_backward.launches += 1
    return dx, g_w1, g_b1, g_w2, g_b2, g_scale, g_bias


power_backward.launches = 0


class _PowerLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj_powers, deg, node_mask, mask, w1, b1, w2, b2,
                scale, bias, run_mean, run_std, momentum, eps, mask_out):
        out, z, stats = power_forward(x, adj_powers, deg, node_mask, mask, w1,
                                      b1, w2, b2, scale, bias, run_mean,
                                      run_std, momentum, eps, mask_out)
        ctx.save_for_backward(x, adj_powers, deg, node_mask, mask, w1, w2,
                              scale, z, stats)
        ctx.mask_out = mask_out
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, adj_powers, deg, node_mask, mask, w1, w2, scale, z, stats = (
            ctx.saved_tensors)
        dx, g_w1, g_b1, g_w2, g_b2, g_scale, g_bias = power_backward(
            g.contiguous(), x, adj_powers, deg, node_mask, mask, w1, w2, scale,
            z, stats, ctx.mask_out, need_dx=ctx.needs_input_grad[0])
        return (dx, None, None, None, None, g_w1, g_b1, g_w2, g_b2, g_scale,
                g_bias, None, None, None, None, None)


def power_layer(x: torch.Tensor, adj_powers: torch.Tensor, deg: torch.Tensor,
                node_mask: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor,
                run_mean: torch.Tensor, run_std: torch.Tensor, momentum: float,
                eps: float, mask_out: bool) -> torch.Tensor:
    """Differentiable train-mode power layer: power_forward forward,
    power_backward backward. Equals composed(...)[0] up to the order of its
    sums; the masks are taken in x's dtype, every input contiguous."""
    c = lambda t: t.contiguous()
    return _PowerLayer.apply(
        c(x), c(adj_powers), c(deg), c(node_mask.to(x.dtype)),
        c(mask.to(x.dtype)), c(w1), c(b1), c(w2), c(b2), scale, bias,
        run_mean, run_std, momentum, eps, mask_out)
