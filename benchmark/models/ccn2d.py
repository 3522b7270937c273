"""CCN-2D through the port: hgnn2_torch.nn.ccn.CCN2D over CCN batches
(data.batching.CCNLoader), with the fused kernels K3/K4 wherever the port
takes them (on the card, K <= 8), served from a CCN bundle."""

from __future__ import annotations

import numpy as np

from benchmark import frozen
from hgnn2_torch import serving
from hgnn2_torch.data import batching
from hgnn2_torch.nn import ccn
from hgnn2_torch.ops import ccn_fused


def build(cfg: dict, device, k_max: int):
    return ccn.CCN2D(n_features=cfg["in_features"], hidden=cfg["h"],
                     n_layers=cfg["L"], dim_output=cfg["dim_output"],
                     kernel=ccn_fused.use_kernel(k_max, device)).to(device)


def train_loader(records, batch: int, cfg: dict, device):
    return batching.CCNLoader(records, batch, task=cfg["task"], device=device)


def deal(mols, batch: int) -> list[np.ndarray]:
    """The molecules of each batch in the loader's deal order: in order."""
    idx = np.arange(len(mols))
    return [idx[s:s + batch] for s in range(0, len(idx), batch)]


def save(path: str, model, records, cfg: dict, mean: float, std: float) -> None:
    k_all = max(r.max_degree() for r in records) + 1
    buckets = [(b, sum(r.n_nodes for r in records[:b])
                + frozen.CCN_CAPACITY_SLACK) for b in frozen.SERVE_BUCKETS]
    serving.save_bundle(path, model, buckets, k_max=k_all, task=cfg["task"],
                        mean=mean, std=std)
