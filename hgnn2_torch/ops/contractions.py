"""CCN promotion and the 18 contractions, plain PyTorch, forward only
(counterpart of hgnn2_tpu/ops/contractions.py).

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

The gather-form custom VJPs come with the training slice.
"""

from __future__ import annotations

import torch


def promote_1d(chi_idx: torch.Tensor, nbr: torch.Tensor,
               f: torch.Tensor) -> torch.Tensor:
    """T[v,k,a] = f[nbr[v,k], chi_idx[v,k,a]] (0 where chi_idx = -1).
    f: (V, K, C). Returns (V, K, K, C)."""
    V, K, C = f.shape
    valid = chi_idx >= 0  # (V, K, K)
    ia = torch.where(valid, chi_idx, 0).long()
    flat = nbr.long()[:, :, None] * K + ia  # (V, K, K) row index into f2
    t = f.reshape(V * K, C)[flat]  # (V, K, K, C)
    return t * valid[..., None].to(f.dtype)


def promote_2d(chi_idx: torch.Tensor, nbr: torch.Tensor,
               f: torch.Tensor) -> torch.Tensor:
    """T[v,k,a,b] = f[nbr[v,k], chi_idx[v,k,a], chi_idx[v,k,b]] (0 where
    either index is -1). f: (V, K, K, C). Returns (V, K, K, K, C)."""
    V, K = f.shape[0], f.shape[1]
    C = f.shape[-1]
    valid = chi_idx >= 0  # (V, K, K)
    ia = torch.where(valid, chi_idx, 0).long()
    base = (nbr.long()[:, :, None] * K + ia) * K  # (V, K, K) [v, k, a]
    flat = base[:, :, :, None] + ia[:, :, None, :]  # (V, K, K, K)
    t = f.reshape(V * K * K, C)[flat]  # (V, K, K, K, C)
    mask = valid[:, :, :, None] & valid[:, :, None, :]
    return t * mask[..., None].to(f.dtype)


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
    K = t.shape[1]
    n = deg.to(t.dtype)[:, None, None, None]  # (V, 1, 1, 1)
    m = row_mask.to(t.dtype)  # (V, K)

    def bcast(val):  # (V, K, C) -> (V, K, K, C): out[i, y] = val[i] m[y]
        return val[:, :, None, :] * m[:, None, :, None]

    eye = torch.eye(K, dtype=t.dtype, device=t.device)[None, :, :, None]

    def diag_embed(val):  # (V, C) -> (V, K, K, C): delta * val * m[i]
        return eye * val[:, None, None, :] * m[:, :, None, None]

    rb = t.sum(dim=3)  # (V, K, K, C): sum_b T[k,a,b]
    sk = t.sum(dim=1)  # (V, K, K, C): sum_k T[k,a,b] -> [a,b]
    sab = rb.sum(dim=2)  # (V, K, C): sum_{a,b} -> [k]
    skb = rb.sum(dim=1)  # (V, K, C): sum_{k,b} -> [a]
    tot = sab.sum(dim=1)  # (V, C)
    diag_aa = torch.einsum("vkaac->vkac", t)  # T[k,a,a]
    tr_ab = diag_aa.sum(dim=2)  # (V, K, C): sum_a T[k,a,a]
    sum_kkb = torch.einsum("vkkbc->vkbc", t).sum(dim=(1, 2))  # (V, C)
    t_kak = torch.einsum("vkakc->vakc", t)  # T[k,a,k] -> [a,k]
    c11_val = t_kak.sum(dim=2)  # (V, K, C): sum_k T[k,a,k] -> [a]
    t_xxx = torch.einsum("vxxxc->vxc", t).sum(dim=1)  # (V, C)

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
