"""CCN promotion and the 18 contractions, plain PyTorch, with their
closed-form adjoints (counterpart of hgnn2_tpu/ops/contractions.py).

These are the plain versions ("twins") of the fused CUDA kernels in
ops/ccn_fused.py: the kernels' wrappers run them for CPU tensors, and
chip_smoke.py holds the kernels against them on the card.

Notation (per vertex v, K padded receptive-field slots, true degree
d = deg[v]): T[v, k, a, b, c] is the promotion tensor (k = neighbor slot,
(a, b) = receptive-field indices, c = channel). chi_ii is the identity, so
each of the 18 contractions of T (x) chi_ii is an O(K^2) reduction of T:

  c1 = n * sum_b T[k,a,b]      c2 = sum_{a,b} T[k,.] bcast   c3 = n * sum_k T
  c4 = sum_{k,b} T[.,a,.] bcast c5 = delta * sum T            c6 = sum_b T
  c7 = c1   c8 = sum_a T[k,a,a] bcast   c9 = c6   c10 = sum_k T
  c11 = sum_k T[k,a,k] bcast   c12 = sum_b T[y,a,b]   c13 = c10
  c14 = delta * sum_{k,b} T[k,k,b]   c15 = delta * sum_{k,a} T[k,a,a]
  c16 = T[k,y,y]   c17 = T[y,a,y]   c18 = delta * sum_x T[x,x,x]

with n = d, bcast masked by row_mask and delta the masked identity. The
compat layout reproduces the original implementation's duplicated
channels: [c1..c5, c6, c1 x 9, c16..c18].

The promotion's adjoint is itself a gather, not a scatter-add: chi
matrices are symmetric across an edge, so every (v, k, a, b) that reads
f[u, p, q] is enumerated from u's side with j = the slot of v in u's list
and rslot[u, j] = the slot of u in its j-th neighbour's list:

  dL/df[u, p, q] = sum_j g[nbr[u,j], rslot[u,j], chi[u,j,p], chi[u,j,q]]

promote_1d/2d(..., rslot=) use that gather as their backward
(autograd.Functions), as the JAX package's custom VJPs do.

promote_contract_18_fused is contract_18(promote_2d(...)) without T, a
loop over the neighbour slots: the high-K path (K > 8), where the fused
kernels refuse.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint as torch_checkpoint

from hgnn2_torch.ops import sparse


def _promote_1d_gather(chi_idx, nbr, f):
    V, K, C = f.shape
    valid = chi_idx >= 0  # (V, K, K)
    ia = torch.where(valid, chi_idx, 0).long()
    flat = nbr.long()[:, :, None] * K + ia  # (V, K, K) row index into f2
    t = f.reshape(V * K, C)[flat]  # (V, K, K, C)
    return t * valid[..., None].to(f.dtype)


def _promote_2d_gather(chi_idx, nbr, f):
    V, K = f.shape[0], f.shape[1]
    C = f.shape[-1]
    valid = chi_idx >= 0  # (V, K, K)
    ia = torch.where(valid, chi_idx, 0).long()
    base = (nbr.long()[:, :, None] * K + ia) * K  # (V, K, K) [v, k, a]
    flat = base[:, :, :, None] + ia[:, :, None, :]  # (V, K, K, K)
    # sparse.gather: its gradient is index_add_ (the vertex chunks take it;
    # every invalid entry reads row 0 of its neighbour, so index_put_'s
    # sorted runs would be thousands long)
    t = sparse.gather(f.reshape(V * K * K, C), flat.reshape(-1)).view(
        *flat.shape, C)  # (V, K, K, K, C)
    mask = valid[:, :, :, None] & valid[:, :, None, :]
    return t * mask[..., None].to(f.dtype)


def promote_1d_bwd(chi_idx: torch.Tensor, rslot: torch.Tensor,
                   nbr: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Adjoint of promote_1d as a gather: g (V, K, K, C) -> df (V, K, C),
    df[u,p] = sum_j g[nbr[u,j], rslot[u,j], chi_idx[u,j,p]] over valid
    (rslot, chi) entries."""
    V, K = g.shape[0], g.shape[1]
    C = g.shape[-1]
    va = chi_idx >= 0  # (V, K, K) [u, j, p]
    vr = rslot >= 0  # (V, K) [u, j]
    sa = torch.where(va, chi_idx, 0).long()
    sr = torch.where(vr, rslot, 0).long()
    flat = (nbr.long() * K + sr)[:, :, None] * K + sa  # (V, K, K)
    vals = g.reshape(V * K * K, C)[flat]  # (V, K, K, C)
    mask = vr[:, :, None] & va
    return (vals * mask[..., None].to(g.dtype)).sum(dim=1)


def promote_2d_bwd(chi_idx: torch.Tensor, rslot: torch.Tensor,
                   nbr: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Adjoint of promote_2d as a gather: g (V, K, K, K, C) -> df
    (V, K, K, C), df[u,p,q] = sum_j g[nbr[u,j], rslot[u,j], chi_idx[u,j,p],
    chi_idx[u,j,q]] over valid entries."""
    V, K = g.shape[0], g.shape[1]
    C = g.shape[-1]
    va = chi_idx >= 0
    vr = rslot >= 0
    sa = torch.where(va, chi_idx, 0).long()
    sr = torch.where(vr, rslot, 0).long()
    rowp = ((nbr.long() * K + sr)[:, :, None] * K + sa) * K  # [u, j, p]
    flat = rowp[:, :, :, None] + sa[:, :, None, :]  # [u, j, p, q]
    vals = g.reshape(V * K * K * K, C)[flat]  # (V, K, K, K, C)
    mask = vr[:, :, None, None] & va[:, :, :, None] & va[:, :, None, :]
    vals = vals * mask[..., None].to(g.dtype)
    # summed over the slots in order j = 0, 1, ..., K - 1, as the CUDA
    # backward (csrc/ccn_fused.cu) sums them, so the two agree bit for bit
    return sum(vals[:, j] for j in range(K))


class _Promote(torch.autograd.Function):
    """promote_1d/2d with the gather-form backward (no scatter-add)."""

    @staticmethod
    def forward(ctx, gather, bwd, chi_idx, rslot, nbr, f):
        ctx.bwd = bwd
        ctx.save_for_backward(chi_idx, rslot, nbr)
        return gather(chi_idx, nbr, f)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        df = None
        if ctx.needs_input_grad[5]:
            df = ctx.bwd(*ctx.saved_tensors, g)
        return None, None, None, None, None, df


def promote_1d(chi_idx: torch.Tensor, nbr: torch.Tensor, f: torch.Tensor,
               rslot: torch.Tensor | None = None) -> torch.Tensor:
    """T[v,k,a] = f[nbr[v,k], chi_idx[v,k,a]] (0 where chi_idx = -1).
    f: (V, K, C). Returns (V, K, K, C). Passing rslot (CCNBatch.rslot)
    makes the backward the gather promote_1d_bwd."""
    if rslot is None:
        return _promote_1d_gather(chi_idx, nbr, f)
    return _Promote.apply(_promote_1d_gather, promote_1d_bwd, chi_idx, rslot,
                          nbr, f)


def promote_2d(chi_idx: torch.Tensor, nbr: torch.Tensor, f: torch.Tensor,
               rslot: torch.Tensor | None = None) -> torch.Tensor:
    """T[v,k,a,b] = f[nbr[v,k], chi_idx[v,k,a], chi_idx[v,k,b]] (0 where
    either index is -1). f: (V, K, K, C). Returns (V, K, K, K, C). Passing
    rslot makes the backward the gather promote_2d_bwd."""
    if rslot is None:
        return _promote_2d_gather(chi_idx, nbr, f)
    return _Promote.apply(_promote_2d_gather, promote_2d_bwd, chi_idx, rslot,
                          nbr, f)


def _promote_slot(fflat, nbr_k, ia_k, va_k, k: int):
    """Neighbour slot k of the 2D promotion, t_k[v,a,b] = T[v,k,a,b]
    (V, K, K, C), and its reductions: rb_k[v,a] = sum_b t_k, diag_k[v,a] =
    t_k[v,a,a] and col_k[v,a] = t_k[v,a,k]."""
    K = ia_k.shape[1]
    base = (nbr_k[:, None] * K + ia_k) * K  # (V, K) [v, a]
    flat = base[:, :, None] + ia_k[:, None, :]  # (V, K, K) [v, a, b]
    m2 = (va_k[:, :, None] & va_k[:, None, :]).to(fflat.dtype)
    t_k = sparse.gather(fflat, flat.reshape(-1)).view(*flat.shape, -1)
    t_k = t_k * m2[..., None]  # (V, K, K, C)
    # copies, not views: a view would keep each slot's t_k alive until the
    # stacks are built, V K^3 C floats in all
    diag_k = torch.diagonal(t_k, dim1=1, dim2=2).movedim(-1, 1).clone()
    return t_k, t_k.sum(dim=2), diag_k, t_k[:, :, k].clone()


def promote_contract_18_fused(chi_idx: torch.Tensor, nbr: torch.Tensor,
                              f: torch.Tensor, deg: torch.Tensor,
                              row_mask: torch.Tensor,
                              compat: bool = False) -> torch.Tensor:
    """contract_18(promote_2d(chi_idx, nbr, f), deg, row_mask, compat)
    without the (V, K, K, K, C) promotion tensor: a loop over the K
    neighbour slots (unrolled; K is fixed per batch, so a CUDA graph
    captures one sequence) gathers one (V, K, K, C) slice t_k a slot and
    reduces it into the O(K^2)-per-vertex sums the 18 contractions read
    (none needs the whole T). Live memory is O(V K^2 C), the high-K regime
    where the materialized path runs out of room.

    Each slot is checkpointed (torch.utils.checkpoint), as the scan body
    of the JAX package is (jax.checkpoint): its gather indices and mask
    are recomputed in the backward, not saved, so the backward keeps the
    same bound (K slots of saved (V, K, K) indices would be V K^3 of
    them). The body draws no random numbers, so no RNG state is stashed
    (preserve_rng_state=False), which a CUDA-graph capture would refuse.
    No host sync. Returns (V, K, K, 18C)."""
    V, K = f.shape[0], f.shape[1]
    C = f.shape[-1]
    valid = chi_idx >= 0  # (V, K, K) [v, k, a]
    ia = torch.where(valid, chi_idx, 0).long()
    nbr = nbr.long()
    fflat = f.reshape(V * K * K, C)
    slot = _promote_slot
    if fflat.requires_grad and torch.is_grad_enabled():
        def slot(*args):
            return torch_checkpoint.checkpoint(
                _promote_slot, *args, use_reentrant=False,
                preserve_rng_state=False)

    sk = f.new_zeros(V, K, K, C)
    sum_kkb, t_xxx = f.new_zeros(V, C), f.new_zeros(V, C)
    c11_val = f.new_zeros(V, K, C)
    rb_s, diag_s, col_s = [], [], []
    for k in range(K):
        t_k, rb_k, diag_k, col_k = slot(fflat, nbr[:, k], ia[:, k],
                                        valid[:, k], k)
        # T[k,k,b] summed over b, T[k,k,k]
        sk, sum_kkb = sk + t_k, sum_kkb + rb_k[:, k]
        t_xxx, c11_val = t_xxx + diag_k[:, k], c11_val + col_k
        rb_s.append(rb_k)
        diag_s.append(diag_k)
        col_s.append(col_k)
    return _channels_18(
        rb=torch.stack(rb_s, dim=1),  # (V, K, K, C) [v, k, a]
        sk=sk,
        diag_aa=torch.stack(diag_s, dim=1),  # [v, k, a] = T[k,a,a]
        t_kak=torch.stack(col_s, dim=2),  # [v, a, k] = T[k,a,k]
        c11_val=c11_val, sum_kkb=sum_kkb, t_xxx=t_xxx, deg=deg,
        row_mask=row_mask, compat=compat)


def contract_1d(t: torch.Tensor) -> torch.Tensor:
    """CCN-1D collapse: concat(sum over k, sum over a) -> (V, K, 2C)."""
    row = t.sum(dim=1)  # (V, K, C) indexed by a
    col = t.sum(dim=2)  # (V, K, C) indexed by k
    return torch.cat([row, col], dim=-1)


def contract_18(t: torch.Tensor, deg: torch.Tensor, row_mask: torch.Tensor,
                compat: bool = False) -> torch.Tensor:
    """The 18 contractions of T (x) chi_ii, fused. -> (V, K, K, 18C).

    t: (V, K, K, K, C) promotion tensor; deg: (V,) true degrees; row_mask:
    (V, K) 1.0 where slot < deg. Channel index is block * C + c.
    """
    t_kak = torch.einsum("vkakc->vakc", t)  # T[k,a,k] -> [a,k]
    return _channels_18(
        rb=t.sum(dim=3),  # (V, K, K, C): sum_b T[k,a,b]
        sk=t.sum(dim=1),  # (V, K, K, C): sum_k T[k,a,b] -> [a,b]
        diag_aa=torch.einsum("vkaac->vkac", t),  # T[k,a,a]
        t_kak=t_kak,
        c11_val=t_kak.sum(dim=2),  # (V, K, C): sum_k T[k,a,k] -> [a]
        sum_kkb=torch.einsum("vkkbc->vkbc", t).sum(dim=(1, 2)),  # (V, C)
        t_xxx=torch.einsum("vxxxc->vxc", t).sum(dim=1),  # (V, C)
        deg=deg, row_mask=row_mask, compat=compat)


def _channels_18(rb, sk, diag_aa, t_kak, c11_val, sum_kkb, t_xxx, deg,
                 row_mask, compat: bool) -> torch.Tensor:
    """The 18 channel blocks (or the compat layout) from the reductions of
    T they read: rb[k,a] = sum_b T, sk[a,b] = sum_k T, diag_aa[k,a] =
    T[k,a,a], t_kak[a,k] = T[k,a,k] (each (V, K, K, C)), c11_val[a] =
    sum_k T[k,a,k] (V, K, C), sum_kkb = sum_{k,b} T[k,k,b] and t_xxx =
    sum_x T[x,x,x] (V, C)."""
    K = rb.shape[1]
    n = deg.to(rb.dtype)[:, None, None, None]  # (V, 1, 1, 1)
    m = row_mask.to(rb.dtype)  # (V, K)

    def bcast(val):  # (V, K, C) -> (V, K, K, C): out[i, y] = val[i] m[y]
        return val[:, :, None, :] * m[:, None, :, None]

    eye = torch.eye(K, dtype=rb.dtype, device=rb.device)[None, :, :, None]

    def diag_embed(val):  # (V, C) -> (V, K, K, C): delta * val * m[i]
        return eye * val[:, None, None, :] * m[:, :, None, None]

    sab = rb.sum(dim=2)  # (V, K, C): sum_{a,b} -> [k]
    skb = rb.sum(dim=1)  # (V, K, C): sum_{k,b} -> [a]
    tot = sab.sum(dim=1)  # (V, C)
    tr_ab = diag_aa.sum(dim=2)  # (V, K, C): sum_a T[k,a,a]

    c1 = n * rb
    c6 = rb
    if compat:
        mid = [c6] + [c1] * 9
    else:
        mid = [
            c6, c1, bcast(tr_ab), c6, sk, bcast(c11_val),
            rb.transpose(1, 2), sk, diag_embed(sum_kkb),
            diag_embed(tr_ab.sum(dim=1)),
        ]
    chans = ([c1, bcast(sab), n * sk, bcast(skb), diag_embed(tot)] + mid
             + [diag_aa, t_kak, diag_embed(t_xxx)])
    return torch.cat(chans, dim=-1)


def contract_1d_transpose(g: torch.Tensor) -> torch.Tensor:
    """Adjoint of contract_1d: g (V, K, 2C) -> gbar (V, K, K, C) with
    gbar[v,k,a] = g_row[v,a] + g_col[v,k] (row sums were indexed by a,
    col sums by k)."""
    C = g.shape[-1] // 2
    g_row, g_col = g[..., :C], g[..., C:]
    return g_row[:, None, :, :] + g_col[:, :, None, :]


def contract_18_transpose_parts(g: torch.Tensor, deg: torch.Tensor,
                                row_mask: torch.Tensor, compat: bool = False):
    """The adjoint of contract_18 in four per-vertex tensors, each
    (V, K, K, C), such that

      gbar[v,k,a,b] = d_sk[v,a,b] + d_rb[v,k,a]
                      + delta_ab * d_diag[v,k,a] + delta_kb * d_kakT[v,k,a]

    O(K^2 C) data per vertex instead of gbar's O(K^3 C): the fused
    backward kernel reads these four by neighbour index."""
    K = g.shape[1]
    C = g.shape[-1] // 18
    gs = [g[..., i * C:(i + 1) * C] for i in range(18)]
    n = deg.to(g.dtype)[:, None, None, None]
    m = row_mask.to(g.dtype)

    # The masked sums over y run in order y = 0, 1, ..., K - 1, one
    # rounded add at a time, as the CUDA backward forms them
    # (csrc/ccn_fused.cu, NbrParts): every step here is one f32
    # operation, so the kernel's values equal these bit for bit.
    def unbcast(gi):  # adjoint of bcast: (V, K, K, C)[i, y] -> (V, K, C)[i]
        return sum(gi[:, :, y] * m[:, None, y, None] for y in range(K))

    def undiag(gi):  # adjoint of diag_embed -> (V, C)
        return sum(gi[:, y, y] * m[:, y, None] for y in range(K))

    eye = torch.eye(K, dtype=g.dtype, device=g.device)[None, :, :, None]
    if compat:  # the middle channels were [c6] + [c1] * 9
        g_c1 = gs[0] + sum(gs[6:15])
        g_c6 = gs[5]
    else:
        g_c1 = gs[0] + gs[6]  # c7 == c1
        g_c6 = gs[5] + gs[8]  # c9 == c6

    # rb[k,a] = sum_b T[k,a,b] receives n*g_c1, g_c6, c2's sum over y,
    # c4's (indexed by a), c12's swapped read, and through c5 (tot) and
    # c14 (sum_k rb[k,k]) the diag_embed channels
    d_rb = n * g_c1 + g_c6 + unbcast(gs[1])[:, :, None, :]
    d_rb = d_rb + unbcast(gs[3])[:, None, :, :]
    if not compat:
        d_rb = d_rb + gs[11].transpose(1, 2)
        d_rb = d_rb + eye * undiag(gs[13])[:, None, None, :]
    d_rb = d_rb + undiag(gs[4])[:, None, None, :]

    # sk[a,b] = sum_k T receives n*g3 (+ g10 + g13)
    d_sk = n * gs[2]
    if not compat:
        d_sk = d_sk + gs[9] + gs[12]

    # diag_aa[k,a] = T[k,a,a] receives c16 (+ bcast c8, diag c15), and
    # c18 through t_xxx = sum_k diag_aa[k,k]
    d_diag = gs[15]
    if not compat:
        d_diag = d_diag + unbcast(gs[7])[:, :, None, :]
        d_diag = d_diag + undiag(gs[14])[:, None, None, :]
    d_diag = d_diag + eye * undiag(gs[17])[:, None, None, :]

    # t_kak[a,k] = T[k,a,k] receives c17 (+ bcast c11 over [a])
    d_kak = gs[16]
    if not compat:
        d_kak = d_kak + unbcast(gs[10])[:, :, None, :]

    return d_sk, d_rb, d_diag, d_kak.transpose(1, 2)


def contract_18_transpose(g: torch.Tensor, deg: torch.Tensor,
                          row_mask: torch.Tensor,
                          compat: bool = False) -> torch.Tensor:
    """Adjoint of contract_18: g (V, K, K, 18C) -> gbar (V, K, K, K, C)
    with <contract_18(t), g> == <t, gbar> for every t (contract_18 is
    linear in t; deg and row_mask are constants)."""
    return gbar_from_parts(*contract_18_transpose_parts(
        g, deg, row_mask, compat=compat))


def gbar_from_parts(d_sk, d_rb, d_diag, d_kakT) -> torch.Tensor:
    """The four parts of contract_18_transpose_parts -> gbar (V, K, K, K, C)."""
    K = d_sk.shape[1]
    eye = torch.eye(K, dtype=d_sk.dtype, device=d_sk.device)
    gbar = d_sk[:, None, :, :, :] + d_rb[:, :, :, None, :]
    gbar = gbar + eye[None, None, :, :, None] * d_diag[:, :, :, None, :]
    return gbar + eye[None, :, None, :, None] * d_kakT[:, :, :, None, :]
