"""Plain reference of the line-graph GNN (the Line Graph Neural Network of
Chen, Li & Bruna, "Supervised Community Detection with Line Graph Neural
Networks", arXiv:1705.08415, as AmmieQi/HGNN-2 runs it with --lg:
models/layers/layers_mnb.py:layer_with_lg_2 at update order 2;
hgnn2_torch/nn/models.py:GNNLineGraph in the port).

The line graph, from each molecule's weighted symmetric adjacency A: one
directed edge e = (u -> v) per nonzero A[u, v] off the diagonal, weight
w_e = A[u, v], rev(e) = (v -> u). As matrices, per graph:

  Pm[u, e] = Pm[v, e] = 1,  Pd[u, e] = +1,  Pd[v, e] = -1   (N, M)
  AL[e, e'] = w_e'  iff  src(e') = dst(e) and e' != rev(e)  (M, M)
  dL = AL 1, the non-backtracking degrees, also the first edge state

The node operator stack of a state X (N, F) is [m X | d X | A X | A^2 X |
A^4 X ...] (d the row sums of A, m the node mask, J adjacency powers); the
edge stack of XL (M, F) is [me XL | dL XL | AL XL | AL^2 XL ...] (me the
edge mask). Each of the L - 1 layers, at update order 2, first updates
the edges from the old node state, then the nodes from the new edge state:

  X1L = [stack_L(XL) | Pm^T X | Pd^T X]
  ZL  = BN_e([cv2(X1L) | relu(cv1(X1L))])
  X1  = [stack(X) | Pm ZL | Pd ZL]
  Z   = BN_n([cv2(X1) | relu(cv1(X1))])

with one batch norm over every real node of the batch (BN_n) and one over
every real directed edge (BN_e): in train mode the batch's mean and std =
sqrt(1e-5 + var), in eval mode the running ones; the output masked. The
readout sums fc([stack(X) | Pm XL | Pd XL]) over the real nodes, the bias
masked with them. Every product goes through ``mm``.

Departures from the published description, each as both packages run it
by default:

- upstream's functions/operators.py increments its edge counter once per
  undirected edge, so its forward edges overwrite the reverse ones and
  the last E slots of its edges, AL, Pm and Pd stay zero (SURVEY.md,
  component 8); this reference builds the intended 2E directed edges,
  one per nonzero of A;
- the diagonal of A (self-loops; QM9 molecules have none) makes no edge;
- the batch norms' scale and bias are per feature (upstream: one scalar
  each), and their running std starts at 1 (upstream: 0);
- the batch norms' output is masked, and the readout's bias counts once
  per real node (upstream lets padded slots through both);
- a batch is padded to its own most atoms and most directed edges, each
  padded slot a zero row and column of every matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import linear

BN_EPS = 1e-5

# TF32 off: every float32 product of the reference in full float32
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def _layers(cfg: dict) -> int:
    """The line-graph layers before the readout (at least one, as the
    models build it)."""
    return max(cfg["L"] - 1, 1)


def _check_order(cfg: dict) -> None:
    if cfg["order"] != 2:
        raise ValueError(f"the reference holds update order 2; got {cfg['order']}")


def param_spec(cfg: dict) -> list[tuple[str, tuple]]:
    _check_order(cfg)
    h, J = cfg["h"], cfg["J"]
    state = 2 * h
    xw, xlw = cfg["in_features"], 1
    spec = []
    for i in range(_layers(cfg)):
        # order 2: the node update reads the new edge state (width 2h), the
        # edge update the old node state (width xw)
        fans = {"node": (J + 2) * xw + 2 * state, "edge": (J + 2) * xlw + 2 * xw}
        for side, fan in fans.items():
            for cv in ("cv1", "cv2"):
                spec += [(f"layer{i}.{side}_{cv}.weight", (h, fan)),
                         (f"layer{i}.{side}_{cv}.bias", (h,))]
            spec += [(f"layer{i}.{side}_bn.scale", (state,)),
                     (f"layer{i}.{side}_bn.bias", (state,))]
        xw = xlw = state
    fan = (J + 2) * xw + 2 * xlw
    return spec + [("layerlast.fc.weight", (cfg["dim_output"], fan)),
                   ("layerlast.fc.bias", (cfg["dim_output"],))]


def buffer_spec(cfg: dict) -> list[tuple[str, tuple]]:
    state = 2 * cfg["h"]
    return [(f"layer{i}.{side}_bn.{s}", (state,)) for i in range(_layers(cfg))
            for side in ("node", "edge") for s in ("mean", "std")]


def directed_edges(adj: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
    """The molecule's directed edges, one per nonzero A[u, v] with u != v in
    row-major order: src, dst, w and rev (the index of (v -> u))."""
    adj = np.asarray(adj)
    off = adj * (1 - np.eye(adj.shape[0], dtype=adj.dtype))
    src, dst = np.nonzero(off)
    index = {(int(u), int(v)): e for e, (u, v) in enumerate(zip(src, dst))}
    rev = np.array([index[(int(v), int(u))] for u, v in zip(src, dst)],
                   dtype=np.int64)
    return src, dst, adj[src, dst].astype(np.float32), rev


def operators(adj: np.ndarray) -> dict[str, np.ndarray]:
    """Pm, Pd (N, M), AL (M, M) and dL (M,) of one molecule."""
    n = adj.shape[0]
    src, dst, w, rev = directed_edges(adj)
    M = len(src)
    e = np.arange(M)
    pm = np.zeros((n, M), np.float32)
    pd = np.zeros((n, M), np.float32)
    pm[src, e] = pm[dst, e] = 1.0
    pd[src, e], pd[dst, e] = 1.0, -1.0
    al = np.where((src[None, :] == dst[:, None]) & (e[None, :] != rev[:, None]),
                  w[None, :], 0.0).astype(np.float32)
    return dict(pm=pm, pd=pd, al=al, dl=al.sum(1))


def inputs(mols, device) -> dict:
    """Node features, adjacency, node and edge masks, Pm, Pd and AL, padded
    to the batch's most atoms N and most directed edges M (padding rows
    and columns zero)."""
    ops = [operators(m.adj) for m in mols]
    B, N = len(mols), max(m.n_nodes for m in mols)
    M = max(max(o["al"].shape[0] for o in ops), 1)
    F = mols[0].x.shape[1]
    arr = dict(x=np.zeros((B, N, F), np.float32),
               adj=np.zeros((B, N, N), np.float32),
               mask=np.zeros((B, N), np.float32),
               emask=np.zeros((B, M), np.float32),
               pm=np.zeros((B, N, M), np.float32),
               pd=np.zeros((B, N, M), np.float32),
               al=np.zeros((B, M, M), np.float32))
    for i, (m, o) in enumerate(zip(mols, ops)):
        n, k = m.n_nodes, o["al"].shape[0]
        arr["x"][i, :n], arr["adj"][i, :n, :n], arr["mask"][i, :n] = m.x, m.adj, 1.0
        arr["emask"][i, :k] = 1.0
        arr["pm"][i, :n, :k], arr["pd"][i, :n, :k] = o["pm"], o["pd"]
        arr["al"][i, :k, :k] = o["al"]
    return {k: torch.from_numpy(v).to(device) for k, v in arr.items()}


def _powers(a: torch.Tensor, J: int, mm) -> list:
    """[a, a^2, a^4, ...]: J matrices by repeated squaring."""
    out = [a]
    for _ in range(1, J):
        out.append(mm(out[-1], out[-1]))
    return out


def _bn(z, m, scale, bias, mean, std, train: bool):
    m = m[..., None]
    zm = z * m
    if train:
        count = m.sum().clamp_min(1.0)
        mean = zm.sum((0, 1)) / count
        std = torch.sqrt(BN_EPS + (((zm - mean) * m) ** 2).sum((0, 1)) / count)
    return (scale * ((zm - mean) / std) + bias) * m


def _pair(params, prefix: str, x1, m, buffers, train: bool, mm):
    """BN([cv2(x1) | relu(cv1(x1))]) of one side of a layer."""
    p = lambda s: params[f"{prefix}_{s}"]
    a = torch.relu(linear(x1, p("cv1.weight"), p("cv1.bias"), mm))
    b = linear(x1, p("cv2.weight"), p("cv2.bias"), mm)
    return _bn(torch.cat([b, a], -1), m, p("bn.scale"), p("bn.bias"),
               buffers[f"{prefix}_bn.mean"], buffers[f"{prefix}_bn.std"], train)


def forward(params: dict, buffers: dict, inp: dict, train: bool, mm):
    n_layers = sum(1 for k in params if k.endswith(".node_cv1.weight"))
    fan_e = params["layer0.edge_cv1.weight"].shape[1]
    J = (fan_e - 2 * inp["x"].shape[-1]) - 2  # (J + 2) * 1 + 2 * in_features
    pm, pd, al = inp["pm"], inp["pd"], inp["al"]
    pm_t, pd_t = pm.transpose(1, 2), pd.transpose(1, 2)
    mask, emask = inp["mask"], inp["emask"]
    deg = inp["adj"].sum(2)[..., None]
    ones = torch.ones(al.shape[:2] + (1,), dtype=al.dtype, device=al.device)
    dl = mm(al, ones)  # (B, M, 1)
    a_pow, al_pow = _powers(inp["adj"], J, mm), _powers(al, J, mm)

    def stack(x):
        return torch.cat([x * mask[..., None], deg * x]
                         + [mm(a, x) for a in a_pow], -1)

    def stack_l(xl):
        return torch.cat([xl * emask[..., None], dl * xl]
                         + [mm(a, xl) for a in al_pow], -1)

    x, xl = inp["x"], dl
    for i in range(n_layers):
        x1l = torch.cat([stack_l(xl), mm(pm_t, x), mm(pd_t, x)], -1)
        zl = _pair(params, f"layer{i}.edge", x1l, emask, buffers, train, mm)
        x1 = torch.cat([stack(x), mm(pm, zl), mm(pd, zl)], -1)
        x = _pair(params, f"layer{i}.node", x1, mask, buffers, train, mm)
        xl = zl
    y = linear(torch.cat([stack(x), mm(pm, xl), mm(pd, xl)], -1),
               params["layerlast.fc.weight"], params["layerlast.fc.bias"], mm)
    return (y * mask[..., None]).sum(1)
