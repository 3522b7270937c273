"""The power GNN through the port: hgnn2_torch.nn.models.GNNSimple over
dense batches (data.batching.DenseLoader, sorted by atoms), served from a
dense bundle."""

from __future__ import annotations

import numpy as np

from benchmark import frozen
from hgnn2_torch import graphs, serving
from hgnn2_torch.data import batching
from hgnn2_torch.nn import models

# hgnn2_torch/scripts/bench_serving.py: the dense bundle's node bucket
SERVE_N_MAX = 32


def build(cfg: dict, device, k_max=None):
    return models.GNNSimple(in_features=cfg["in_features"], n_features=cfg["h"],
                            n_layers=cfg["L"], dim_output=cfg["dim_output"],
                            J=cfg["J"]).to(device)


def train_loader(records, batch: int, cfg: dict, device):
    return batching.DenseLoader(records, batch, task=cfg["task"], sort=True,
                                device=device)


def deal(mols, batch: int) -> list[np.ndarray]:
    """The molecules of each batch in the loader's deal order: sorted by
    atoms (stable), then cut into batches."""
    order = np.argsort([m.n_nodes for m in mols], kind="stable")
    return [order[s:s + batch] for s in range(0, len(order), batch)]


def save(path: str, model, records, cfg: dict, mean: float, std: float) -> None:
    samples = [graphs.make_dense_batch(records[:b], n_max=SERVE_N_MAX,
                                       batch_size=b, task=cfg["task"],
                                       device="cpu")
               for b in frozen.SERVE_BUCKETS]
    serving.save_bundle(path, model, samples, task=cfg["task"], mean=mean,
                        std=std)
