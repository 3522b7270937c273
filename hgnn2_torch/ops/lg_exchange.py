"""The line-graph exchange in index form: [Pm xl | Pd xl], [Pm^T x | Pd^T x]
and the non-backtracking apply as gathers and segment sums over each
graph's src, dst and rev: the one exchange of nn/bundles.py:DenseBundle,
on every device and in every float dtype. Wrappers of the CUDA kernels in
csrc/lg_exchange.cu, joined by torch.autograd.Functions, and the same
functions in plain PyTorch.

  pm_pd_forward     (B, M, F) -> (B, N, 2F)  [Pm xl | Pd xl]
  pm_pd_backward    (B, N, 2F) -> (B, M, F)  its gradient
  pm_pd_t_forward   (B, N, F) -> (B, M, 2F)  [Pm^T x | Pd^T x]
  pm_pd_t_backward  (B, M, 2F) -> (B, N, F)  its gradient
  nb_forward        (B, M, F) -> (B, M, F)   AL xl, or with dl (B, M, 3F):
                                             [xl emask | dl xl | AL xl]
  nb_backward       the gradient of either

pm_pd, pm_pd_t, nb_apply, lg_graph_op and nb_degrees are the
differentiable functions the bundle calls. They compute what ops/dense.py's
one-hot composition computes (edge_scatter_matrices, incidence_(t_)apply,
nb_apply, lg_graph_op), padded edges included: there rev is 0, so AL xl
reads edge 0 and its gradient flows back into edge 0. Only the order of
the segment sums differs. The JAX package has no kernel here (XLA fuses
its einsums on the TPU); on the H100 the composition is cuBLAS GEMVs that
read the whole one-hot (B, N, M) matrices to move a few floats an edge.

Each raw wrapper alone picks its path. Where use_kernel holds (CUDA
float32 tensors) it launches its kernel (one launch, on the current
stream) and adds one to its ``launches`` count; a kernel that cannot run
raises. Elsewhere (the CPU, float64, bf16) it runs the plain PyTorch
version (the ``*_reference`` functions: gathers and ``index_add_``) and
counts nothing; bf16 inputs run it in float32 and its output is rounded
to bf16 once, the rounding ops/dense.py's einsums give bf16 (f32
accumulation, one rounding). An index out of range (src, dst outside
[0, N), rev outside [0, M)) adds nothing on either path. The features
are differentiated, the indices, weights, mask and NB degrees are
constants.
"""

from __future__ import annotations

import ctypes

import torch

from hgnn2_torch.ops import cuda_build

# csrc/lg_exchange.cu: the staged kernels' block and the shared memory a
# block may stage
THREADS = 128
SMEM_BYTES = 48 * 1024

# the kernels' C entries: (name, argtypes), for cuda_build.entry
_P, _I = ctypes.c_void_p, ctypes.c_int
_TO_NODES = ("hgnn2_lg_to_nodes", [_P] * 5 + [_I] * 6 + [_P])
_TO_EDGES = ("hgnn2_lg_to_edges", [_P] * 5 + [_I] * 5 + [_P])
_NB_FORWARD = ("hgnn2_lg_nb_forward", [_P] * 9 + [_I] * 6 + [_P])
_NB_BACKWARD = ("hgnn2_lg_nb_backward", [_P] * 9 + [_I] * 6 + [_P])


def use_kernel(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether the wrappers launch the kernels: on CUDA, in float32. The
    CPU, bf16 and float64 run the plain versions."""
    return dtype == torch.float32 and torch.device(device).type == "cuda"


# ------------------------------------------------------------ plain versions


def _segment_sum(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """out[b, i] = sum of vals[b, e] over e with idx[b, e] == i, for i in
    [0, n): idx (B, M), vals (B, M, F) -> (B, n, F). Entries out of range
    add nothing."""
    B, M, F = vals.shape
    ok = (idx >= 0) & (idx < n)
    rows = torch.arange(B, device=idx.device)[:, None] * n + idx.long().clamp(0, n - 1)
    out = vals.new_zeros(B * n, F)
    out.index_add_(0, rows.reshape(-1),
                   torch.where(ok[..., None], vals, 0.0).reshape(-1, F))
    return out.view(B, n, F)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, e]] for x (B, N, F), idx (B, M) -> (B, M, F); 0 where
    idx is out of range."""
    N, F = x.shape[1], x.shape[2]
    ok = (idx >= 0) & (idx < N)
    i = idx.long().clamp(0, N - 1)[..., None].expand(-1, -1, F)
    return torch.where(ok[..., None], torch.gather(x, 1, i), 0.0)


def pm_pd_reference(src, dst, emask, xl: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """[Pm xl | Pd xl]: A + D and A - D, A and D the sums of emask xl
    over the edges leaving and entering each node."""
    v = emask[..., None] * xl
    a, d = _segment_sum(src, v, n_nodes), _segment_sum(dst, v, n_nodes)
    return torch.cat([a + d, a - d], -1)


def pm_pd_grad_reference(src, dst, emask, g: torch.Tensor) -> torch.Tensor:
    """pm_pd's gradient: g = [g_m | g_d] (B, N, 2F) -> (B, M, F),
    emask (g_m + g_d)[src] + emask (g_m - g_d)[dst]."""
    F = g.shape[-1] // 2
    gm, gd = g[..., :F], g[..., F:]
    m = emask[..., None]
    return m * _gather(gm + gd, src) + m * _gather(gm - gd, dst)


def pm_pd_t_reference(src, dst, emask, x: torch.Tensor) -> torch.Tensor:
    """[Pm^T x | Pd^T x]: a + c and a - c, a = emask x[src], c = emask
    x[dst]."""
    m = emask[..., None]
    a, c = m * _gather(x, src), m * _gather(x, dst)
    return torch.cat([a + c, a - c], -1)


def pm_pd_t_grad_reference(src, dst, emask, g: torch.Tensor,
                           n_nodes: int) -> torch.Tensor:
    """pm_pd_t's gradient: g = [g_m | g_d] (B, M, 2F) -> (B, N, F), the
    segment sums of emask (g_m + g_d) over src and emask (g_m - g_d) over
    dst."""
    F = g.shape[-1] // 2
    gm, gd = g[..., :F], g[..., F:]
    m = emask[..., None]
    return (_segment_sum(src, m * (gm + gd), n_nodes)
            + _segment_sum(dst, m * (gm - gd), n_nodes))


def nb_reference(src, dst, rev, emask, w, xl: torch.Tensor, n_nodes: int,
                 dl: torch.Tensor | None = None) -> torch.Tensor:
    """(AL xl)[e] = emask[e] Y[dst e] - w[rev e] xl[rev e], Y[n] = the sum
    of emask w xl over the edges leaving n. With dl: [xl emask | dl xl |
    AL xl]."""
    m = emask[..., None]
    wx = w[..., None] * xl
    y = _segment_sum(src, m * wx, n_nodes)
    al = m * _gather(y, dst) - _gather(wx, rev)
    if dl is None:
        return al
    return torch.cat([xl * m, dl[..., None] * xl, al], -1)


def nb_grad_reference(src, dst, rev, emask, w, g: torch.Tensor, n_nodes: int,
                      dl: torch.Tensor | None = None) -> torch.Tensor:
    """nb_reference's gradient: g (B, M, F), or (B, M, 3F) = [g_id | g_dl
    | g_al] with dl -> (B, M, F). w (emask G[src]) less the sum of g_al
    w over the edges whose rev is this one, G[n] the sum of emask g_al
    over the edges entering n; with dl plus emask g_id + dl g_dl."""
    F = g.shape[-1] // 3 if dl is not None else g.shape[-1]
    gal = g[..., -F:]
    m, wv = emask[..., None], w[..., None]
    gsum = _segment_sum(dst, m * gal, n_nodes)
    back = _segment_sum(rev, gal * _gather(wv, rev), rev.shape[1])
    out = wv * (m * _gather(gsum, src)) - back
    if dl is None:
        return out
    return m * g[..., :F] + dl[..., None] * g[..., F:2 * F] + out


# ------------------------------------------------------------------ kernels


def _graph_words(kind: str, N: int, M: int, F: int) -> int:
    """4-byte words one graph stages in shared memory
    (csrc/lg_exchange.cu:to_nodes_smem, nb_smem): its src, dst and emask
    and its input rows (to_nodes; 2F wide for the backward's g), or src,
    dst, rev, emask, w, its F-wide edge rows and its node sums (nb)."""
    if kind == "to_nodes_pair":
        return 3 * M + M * F
    if kind == "to_nodes_sum":
        return 3 * M + 2 * M * F
    return 5 * M + M * F + N * F


def _graphs_per_block(kind: str, N: int, M: int, F: int) -> int:
    """G, the graphs a block of the staged kernels takes: as many as give
    its THREADS threads about one (node or edge, feature) item each (the
    to_nodes kernels' N F a graph, the NB kernels' larger phase, max(N,
    M) F), at least 1, as far as they fit SMEM_BYTES; 0 where one graph
    does not fit (the looped instantiation)."""
    fit = SMEM_BYTES // (4 * max(_graph_words(kind, N, M, F), 1))
    if fit == 0:
        return 0
    items = (N if kind.startswith("to_nodes") else max(N, M)) * F
    return min(max(THREADS // max(items, 1), 1), fit)


def _check(src, dst, emask, feats: torch.Tensor, rows: int, width: int,
           **more) -> bool:
    """Device, dtype and shape checks shared by the wrappers: src, dst
    (and rev) (B, M) int32, emask (and w, dl) (B, M) in the features'
    dtype, feats (B, rows, width), all on the features' device. Returns
    use_kernel, whose kernels also need every tensor contiguous."""
    B, M = src.shape
    if tuple(feats.shape) != (B, rows, width):
        raise ValueError(f"features must be {(B, rows, width)}; got {tuple(feats.shape)}")
    tensors = {"src": src, "dst": dst, "emask": emask,
               **{k: v for k, v in more.items() if v is not None}}
    for name, t in tensors.items():
        if tuple(t.shape) != (B, M):
            raise ValueError(f"{name} must be {(B, M)}; got {tuple(t.shape)}")
        want = torch.int32 if name in ("src", "dst", "rev") else feats.dtype
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, must be {want}")
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, the features on {feats.device}")
    if not use_kernel(feats.device, feats.dtype):
        return False
    for name, t in {**tensors, "features": feats}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return True


def _plain(fn, *args) -> torch.Tensor:
    """The plain version fn on args. Its float tensors share one dtype
    (_check); narrower than float32 (bf16), fn runs on float32 copies and
    its output is rounded to that dtype once."""
    dt = next(a.dtype for a in args if torch.is_tensor(a) and a.is_floating_point())
    if torch.finfo(dt).bits >= 32:
        return fn(*args)
    return fn(*[a.float() if torch.is_tensor(a) and a.is_floating_point() else a
                for a in args]).to(dt)


def _to_nodes(src, dst, emask, feats, n_nodes: int, pair: bool):
    B, M, fi = feats.shape
    F = fi if pair else fi // 2
    out = torch.empty((B, n_nodes, 2 * F if pair else F), dtype=feats.dtype,
                      device=feats.device)
    G = _graphs_per_block("to_nodes_pair" if pair else "to_nodes_sum",
                          n_nodes, M, F)
    cuda_build.launch(cuda_build.entry("lg_exchange", *_TO_NODES), feats.device,
                      src.data_ptr(), dst.data_ptr(), emask.data_ptr(),
                      feats.data_ptr(), out.data_ptr(), B, n_nodes, M, F,
                      int(pair), G)
    return out


def _to_edges(src, dst, emask, feats, pair: bool):
    B, N, fi = feats.shape
    M = src.shape[1]
    F = fi if pair else fi // 2
    out = torch.empty((B, M, 2 * F if pair else F), dtype=feats.dtype,
                      device=feats.device)
    cuda_build.launch(cuda_build.entry("lg_exchange", *_TO_EDGES), feats.device,
                      src.data_ptr(), dst.data_ptr(), emask.data_ptr(),
                      feats.data_ptr(), out.data_ptr(), B, N, M, F, int(pair))
    return out


def _nb(spec, src, dst, rev, emask, w, dl, feats, out_width, n_nodes, F):
    B, M = src.shape
    out = torch.empty((B, M, out_width), dtype=feats.dtype, device=feats.device)
    G = _graphs_per_block("nb", n_nodes, M, F)
    scratch = (torch.empty((B, n_nodes, F), dtype=feats.dtype,
                           device=feats.device) if G == 0 else None)
    cuda_build.launch(cuda_build.entry("lg_exchange", *spec), feats.device,
                      src.data_ptr(), dst.data_ptr(), rev.data_ptr(),
                      emask.data_ptr(), w.data_ptr(),
                      0 if dl is None else dl.data_ptr(), feats.data_ptr(),
                      out.data_ptr(),
                      0 if scratch is None else scratch.data_ptr(), B,
                      n_nodes, M, F, int(dl is not None), G)
    return out


def pm_pd_forward(src, dst, emask, xl: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """[Pm xl | Pd xl] in one kernel: xl (B, M, F) -> (B, N, 2F)."""
    B, M = src.shape
    if not _check(src, dst, emask, xl, M, xl.shape[-1]):
        return _plain(pm_pd_reference, src, dst, emask, xl, n_nodes)
    out = _to_nodes(src, dst, emask, xl, n_nodes, pair=True)
    pm_pd_forward.launches += 1
    return out


def pm_pd_backward(src, dst, emask, g: torch.Tensor) -> torch.Tensor:
    """pm_pd's gradient in one kernel: g (B, N, 2F) -> (B, M, F)."""
    if not _check(src, dst, emask, g, g.shape[1], 2 * (g.shape[-1] // 2)):
        return _plain(pm_pd_grad_reference, src, dst, emask, g)
    out = _to_edges(src, dst, emask, g, pair=False)
    pm_pd_backward.launches += 1
    return out


def pm_pd_t_forward(src, dst, emask, x: torch.Tensor) -> torch.Tensor:
    """[Pm^T x | Pd^T x] in one kernel: x (B, N, F) -> (B, M, 2F)."""
    if not _check(src, dst, emask, x, x.shape[1], x.shape[-1]):
        return _plain(pm_pd_t_reference, src, dst, emask, x)
    out = _to_edges(src, dst, emask, x, pair=True)
    pm_pd_t_forward.launches += 1
    return out


def pm_pd_t_backward(src, dst, emask, g: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """pm_pd_t's gradient in one kernel: g (B, M, 2F) -> (B, N, F)."""
    if not _check(src, dst, emask, g, src.shape[1], 2 * (g.shape[-1] // 2)):
        return _plain(pm_pd_t_grad_reference, src, dst, emask, g, n_nodes)
    out = _to_nodes(src, dst, emask, g, n_nodes, pair=False)
    pm_pd_t_backward.launches += 1
    return out


def nb_forward(src, dst, rev, emask, w, xl: torch.Tensor, n_nodes: int,
               dl: torch.Tensor | None = None) -> torch.Tensor:
    """AL xl (B, M, F) in one kernel; with dl the whole [xl emask | dl xl |
    AL xl] (B, M, 3F), lg_graph_op at J = 1."""
    F = xl.shape[-1]
    if not _check(src, dst, emask, xl, src.shape[1], F, rev=rev, w=w, dl=dl):
        return _plain(nb_reference, src, dst, rev, emask, w, xl, n_nodes, dl)
    out = _nb(_NB_FORWARD, src, dst, rev, emask, w, dl, xl,
              F if dl is None else 3 * F, n_nodes, F)
    nb_forward.launches += 1
    return out


def nb_backward(src, dst, rev, emask, w, g: torch.Tensor, n_nodes: int,
                dl: torch.Tensor | None = None) -> torch.Tensor:
    """nb_forward's gradient in one kernel: g (B, M, F), or (B, M, 3F)
    with dl -> (B, M, F)."""
    fg = g.shape[-1]
    F = fg // 3 if dl is not None else fg
    if not _check(src, dst, emask, g, src.shape[1],
                  3 * F if dl is not None else F, rev=rev, w=w, dl=dl):
        return _plain(nb_grad_reference, src, dst, rev, emask, w, g, n_nodes,
                      dl)
    out = _nb(_NB_BACKWARD, src, dst, rev, emask, w, dl, g, F,
              n_nodes, F)
    nb_backward.launches += 1
    return out


for _fn in (pm_pd_forward, pm_pd_backward, pm_pd_t_forward, pm_pd_t_backward,
            nb_forward, nb_backward):
    _fn.launches = 0


# ------------------------------------------------- the autograd Functions


class _PmPd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xl, src, dst, emask, n_nodes):
        ctx.save_for_backward(src, dst, emask)
        return pm_pd_forward(src, dst, emask, xl, n_nodes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        src, dst, emask = ctx.saved_tensors
        return pm_pd_backward(src, dst, emask, g.contiguous()), None, None, None, None


class _PmPdT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, emask):
        ctx.save_for_backward(src, dst, emask)
        ctx.n_nodes = x.shape[1]
        return pm_pd_t_forward(src, dst, emask, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        src, dst, emask = ctx.saved_tensors
        return (pm_pd_t_backward(src, dst, emask, g.contiguous(), ctx.n_nodes),
                None, None, None)


class _NB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xl, src, dst, rev, emask, w, dl, n_nodes):
        ctx.save_for_backward(src, dst, rev, emask, w, dl)
        ctx.n_nodes = n_nodes
        return nb_forward(src, dst, rev, emask, w, xl, n_nodes, dl)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        src, dst, rev, emask, w, dl = ctx.saved_tensors
        return (nb_backward(src, dst, rev, emask, w, g.contiguous(), ctx.n_nodes,
                            dl), None, None, None, None, None, None, None)


def pm_pd(src, dst, emask, xl: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Differentiable [Pm xl | Pd xl]: (B, M, F) -> (B, N, 2F)."""
    return _PmPd.apply(xl.contiguous(), src, dst, emask, n_nodes)


def pm_pd_t(src, dst, emask, x: torch.Tensor) -> torch.Tensor:
    """Differentiable [Pm^T x | Pd^T x]: (B, N, F) -> (B, M, 2F)."""
    return _PmPdT.apply(x.contiguous(), src, dst, emask)


def nb_apply(src, dst, rev, emask, w, xl: torch.Tensor, n_nodes: int,
             dl: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable AL xl, or with dl [xl emask | dl xl | AL xl]."""
    return _NB.apply(xl.contiguous(), src, dst, rev, emask, w, dl, n_nodes)


def lg_graph_op(src, dst, rev, emask, w, dl, xl: torch.Tensor, J: int,
                n_nodes: int) -> torch.Tensor:
    """[I, diag(dL), AL, AL^2, AL^4, ...] applied to xl, as ops/dense.py's
    lg_graph_op with the edge mask: (B, M, F) -> (B, M, (J+2) F). The
    first three blocks are one launch; each further AL apply is one more
    (AL^(2^(j-1)) by repeated applies), joined by a cat."""
    out = nb_apply(src, dst, rev, emask, w, xl, n_nodes, dl)
    if J == 1:
        return out
    F = xl.shape[-1]
    blocks, cur, applied = [out], out[..., 2 * F:], 1
    for j in range(1, J):
        while applied < 2 ** j:
            cur = nb_apply(src, dst, rev, emask, w, cur, n_nodes)
            applied += 1
        blocks.append(cur)
    return torch.cat(blocks, dim=-1)


def nb_degrees(src, dst, rev, emask, w, n_nodes: int) -> torch.Tensor:
    """The NB line-graph degrees dl = (AL 1) emask, (B, M): ops/dense.py's
    nb_degrees times the edge mask, one NB apply on a ones input."""
    ones = torch.ones(w.shape + (1,), dtype=w.dtype, device=w.device)
    return nb_forward(src, dst, rev, emask, w, ones, n_nodes)[..., 0] * emask
