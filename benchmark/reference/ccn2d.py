"""Plain reference of the second-order covariant compositional network
(CCN-2D of the original HGNN-2 code, hgnn2_torch/nn/ccn.py in the port).

Every vertex v has the receptive field R_v = its neighbours and itself in
ascending order (d_v = |R_v| <= K slots), and a state f_v (K, K, C) over
R_v x R_v. A layer promotes each neighbour's state into v's frame,
T_v[k, a, b] = f_{R_v[k]}[chi(R_v[k], R_v[a]), chi(R_v[k], R_v[b])]
(chi(u, w) = the slot of w in R_u; zero where w is not in R_u), takes the
18 contractions of T_v listed in _contractions, then a shared Linear,
ReLU and the mask of real (a, b) slots. The readout after the input and
after each layer sums each vertex's state over (a, b) and the vertices of
each graph; fc maps their concatenation to the output. The tables are
rebuilt here from the molecules (self-loops added, as the port's CCN
loader and serving bundles do by default).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import linear

N_CONTRACTIONS = 18


def param_spec(cfg: dict) -> list[tuple[str, tuple]]:
    h, L, F = cfg["h"], cfg["L"], cfg["in_features"]
    spec, width = [], F
    for i in range(L):
        spec += [(f"w{i + 1}.weight", (h, N_CONTRACTIONS * width)),
                 (f"w{i + 1}.bias", (h,))]
        width = h
    return spec + [("fc.weight", (cfg["dim_output"], F + L * h)),
                   ("fc.bias", (cfg["dim_output"],))]


def buffer_spec(cfg: dict) -> list[tuple[str, tuple]]:
    return []


def tables(mols) -> dict:
    """Receptive fields and chi tables of a batch, numpy: x (V, F), nbr
    (V, K) global vertex of each slot (-1 past d_v), chi (V, K, K)
    = chi(nbr[v, k], nbr[v, a]) or -1, deg (V,), gid (V,)."""
    us, ws, gids, xs, off = [], [], [], [], 0
    for g, m in enumerate(mols):
        a = (np.asarray(m.adj) > 0) | np.eye(m.n_nodes, dtype=bool)
        u, w = np.nonzero(a)  # row-major: ascending w within each u
        us.append(u + off)
        ws.append(w + off)
        gids.append(np.full(m.n_nodes, g))
        xs.append(m.x)
        off += m.n_nodes
    u, w = np.concatenate(us), np.concatenate(ws)
    V = off
    deg = np.bincount(u, minlength=V)
    K = int(deg.max())
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(len(u)) - start[u]
    nbr = np.full((V, K), -1, np.int64)
    nbr[u, slot] = w
    keys = u.astype(np.int64) * V + w  # sorted: u ascending, w within u
    valid = nbr >= 0
    safe = np.where(valid, nbr, 0)
    q = safe[:, :, None] * V + safe[:, None, :]  # (V, K, K): key (nbr k, nbr a)
    idx = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    found = (keys[idx] == q) & valid[:, :, None] & valid[:, None, :]
    chi = np.where(found, slot[idx], -1)
    return dict(x=np.concatenate(xs).astype(np.float32), nbr=nbr, chi=chi,
                deg=deg.astype(np.float32), gid=np.concatenate(gids),
                n_graphs=len(mols))


def inputs(mols, device) -> dict:
    t = tables(mols)
    out = {k: torch.from_numpy(v).to(device) for k, v in t.items()
           if isinstance(v, np.ndarray)}
    out["n_graphs"] = t["n_graphs"]
    return out


def _promote(f: torch.Tensor, nbr, chi) -> torch.Tensor:
    """T[v, k, a, b] = f[nbr[v,k], chi[v,k,a], chi[v,k,b]], zero where any
    index is missing. f (V, K, K, C) -> (V, K, K, K, C)."""
    valid = chi >= 0
    c = chi.clamp_min(0)
    n = nbr.clamp_min(0)[:, :, None, None].expand(-1, -1, c.shape[2], c.shape[2])
    t = f[n, c[:, :, :, None], c[:, :, None, :]]
    mask = (valid[:, :, :, None] & valid[:, :, None, :])[..., None]
    return t * mask


def _contractions(t: torch.Tensor, deg, row) -> torch.Tensor:
    """The 18 contractions of T (x) chi_ii, (V, K, K, 18C), channel block
    i * C + c; out[v, i, y] over the slots of v (row[v, i] marks i < d_v).
    With sums over the named axes of T[k, a, b]:
      1 d sum_b T[i,y,b]     2 sum_{a,b} T[i,a,b] (row y)   3 d sum_k T[k,i,y]
      4 sum_{k,b} T[k,i,b] (row y)   5 delta_iy sum_{k,a,b} T
      6 sum_b T[i,y,b]       7 = 1    8 sum_a T[i,a,a] (row y)   9 = 6
      10 sum_k T[k,i,y]      11 sum_k T[k,i,k] (row y)   12 sum_b T[y,i,b]
      13 = 10    14 delta_iy sum_{k,b} T[k,k,b]   15 delta_iy sum_{k,a} T[k,a,a]
      16 T[i,y,y]   17 T[y,i,y]   18 delta_iy sum_x T[x,x,x]
    where "(row y)" broadcasts over y < d_v and delta_iy is masked by
    i < d_v."""
    K = t.shape[1]
    n = deg[:, None, None, None]
    m = row[:, None, :, None]  # over y
    mi = row[:, :, None, None]  # over i
    eye = torch.eye(K, dtype=t.dtype, device=t.device)[None, :, :, None]
    rb = t.sum(3)  # [k, a] = sum_b
    sk = t.sum(1)  # [a, b] = sum_k
    diag = torch.diagonal(t, dim1=2, dim2=3).movedim(-1, 2)  # [k, a] = T[k,a,a]
    kak = torch.diagonal(t, dim1=1, dim2=3).movedim(-1, 2)  # [a, k] = T[k,a,k]

    def row_b(v):  # (V, K, C) indexed by i -> (V, K, K, C) over y
        return v[:, :, None, :] * m

    def delta(v):  # (V, C) -> (V, K, K, C)
        return eye * v[:, None, None, :] * mi

    kkb = torch.diagonal(rb, dim1=1, dim2=2).sum(-1)  # sum_k rb[k, k]
    xxx = torch.diagonal(diag, dim1=1, dim2=2).sum(-1)  # sum_x T[x,x,x]
    chans = [n * rb, row_b(rb.sum(2)), n * sk, row_b(rb.sum(1)),
             delta(rb.sum((1, 2))), rb, n * rb, row_b(diag.sum(2)), rb, sk,
             row_b(kak.sum(2)), rb.transpose(1, 2), sk, delta(kkb),
             delta(diag.sum((1, 2))), diag, kak, delta(xxx)]
    return torch.cat(chans, dim=-1)


def _readout(f, inp) -> torch.Tensor:
    per_vertex = f.sum((1, 2))
    out = torch.zeros(inp["n_graphs"], f.shape[-1], dtype=f.dtype,
                      device=f.device)
    return out.index_add(0, inp["gid"], per_vertex)


def forward(params: dict, buffers: dict, inp: dict, train: bool, mm):
    row = (inp["nbr"] >= 0).to(torch.float32)
    mask = (row[:, :, None] * row[:, None, :])[..., None]
    V, K = row.shape
    f = inp["x"][:, None, None, :] * mask
    sums = [_readout(f, inp)]
    i = 1
    while f"w{i}.weight" in params:
        t = _promote(f, inp["nbr"], inp["chi"])
        z = _contractions(t, inp["deg"], row)
        f = torch.relu(linear(z, params[f"w{i}.weight"], params[f"w{i}.bias"],
                              mm)) * mask
        sums.append(_readout(f, inp))
        i += 1
    return linear(torch.cat(sums, -1), params["fc.weight"], params["fc.bias"], mm)
