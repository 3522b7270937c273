"""Plain reference of the power GNN (GNNSimple of the original HGNN-2 code,
hgnn2_torch/nn/models.py in the port).

Per graph, with A the weighted adjacency, d its row sums and m the node
mask, the operator stack applied to a state X (n, F) is
[m X | d X | A X | A^2 X | A^4 X ...] (J adjacency powers). Each of the
L - 1 layers maps X1 = stack(X) to BN([relu(X1 W2 + b2) | relu(X1 W1 + b1)])
with a batch norm over every real node of the batch (train: the batch's
mean and std = sqrt(1e-5 + var), masked output; eval: the running ones).
The readout sums fc(stack(X)) over the real nodes.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import linear

BN_EPS = 1e-5


def _widths(cfg: dict) -> list[int]:
    h, L = cfg["h"], cfg["L"]
    return [cfg["in_features"]] + [2 * h] * (L - 1)


def param_spec(cfg: dict) -> list[tuple[str, tuple]]:
    h, J, L = cfg["h"], cfg["J"], cfg["L"]
    w = _widths(cfg)
    spec = []
    for i in range(L - 1):
        fan = (J + 2) * w[i]
        for cv in ("cv1", "cv2"):
            spec += [(f"layer{i}.{cv}.weight", (h, fan)),
                     (f"layer{i}.{cv}.bias", (h,))]
        spec += [(f"layer{i}.bn.scale", (2 * h,)), (f"layer{i}.bn.bias", (2 * h,))]
    fan = (J + 2) * w[L - 1]
    return spec + [("layerlast.fc.weight", (cfg["dim_output"], fan)),
                   ("layerlast.fc.bias", (cfg["dim_output"],))]


def buffer_spec(cfg: dict) -> list[tuple[str, tuple]]:
    h = cfg["h"]
    return [(f"layer{i}.bn.{s}", (2 * h,)) for i in range(cfg["L"] - 1)
            for s in ("mean", "std")]


def inputs(mols, device) -> dict:
    """Node features, adjacency and node mask, padded to the batch's most
    atoms (padding rows and columns zero)."""
    B, N = len(mols), max(m.n_nodes for m in mols)
    F = mols[0].x.shape[1]
    x = np.zeros((B, N, F), np.float32)
    adj = np.zeros((B, N, N), np.float32)
    mask = np.zeros((B, N), np.float32)
    for i, m in enumerate(mols):
        n = m.n_nodes
        x[i, :n], adj[i, :n, :n], mask[i, :n] = m.x, m.adj, 1.0
    return {k: torch.from_numpy(v).to(device)
            for k, v in dict(x=x, adj=adj, mask=mask).items()}


def _stack(inp: dict, powers: list, x: torch.Tensor, mm) -> torch.Tensor:
    m = inp["mask"][..., None]
    deg = inp["adj"].sum(2)[..., None]
    return torch.cat([x * m, deg * x] + [mm(a, x) for a in powers], dim=-1)


def _bn(z, m, scale, bias, mean, std, train: bool):
    m = m[..., None]
    zm = z * m
    if train:
        count = m.sum().clamp_min(1.0)
        mean = zm.sum((0, 1)) / count
        std = torch.sqrt(BN_EPS + (((zm - mean) * m) ** 2).sum((0, 1)) / count)
    return (scale * ((zm - mean) / std) + bias) * m


def forward(params: dict, buffers: dict, inp: dict, train: bool, mm):
    n_layers = sum(1 for k in params if k.endswith(".cv1.weight")) + 1
    J = params["layer0.cv1.weight"].shape[1] // inp["x"].shape[-1] - 2
    powers = [inp["adj"]]
    for _ in range(1, J):
        powers.append(mm(powers[-1], powers[-1]))
    x = inp["x"]
    for i in range(n_layers - 1):
        p = lambda s: params[f"layer{i}.{s}"]
        x1 = _stack(inp, powers, x, mm)
        a = torch.relu(linear(x1, p("cv1.weight"), p("cv1.bias"), mm))
        b = torch.relu(linear(x1, p("cv2.weight"), p("cv2.bias"), mm))
        x = _bn(torch.cat([b, a], -1), inp["mask"], p("bn.scale"), p("bn.bias"),
                buffers[f"layer{i}.bn.mean"], buffers[f"layer{i}.bn.std"], train)
    y = linear(_stack(inp, powers, x, mm), params["layerlast.fc.weight"],
               params["layerlast.fc.bias"], mm)
    return (y * inp["mask"][..., None]).sum(1)
