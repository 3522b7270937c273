"""Serving bundles for the CCN models (counterpart of the CCN half of
hgnn2_tpu/serving.py).

A bundle is a directory:
    model.pt    the model's state_dict (float32 tensors)
    meta.json   kind, arch, task, target mean/std, one input_spec per
                serving bucket, add_self_loops, and the hyperparameters
                that rebuild the model (n_features, n_layers, hidden,
                dim_output, compat_contractions)

The JAX bundle froze a StableHLO program per bucket; here the buckets are
shape specs and one set of weights serves all of them, since PyTorch runs
eagerly. ``load_bundle(path).predict(records)`` packs an arbitrary number
of GraphRecords into the buckets chunk by chunk, runs the eval forward
under ``torch.inference_mode()`` and returns denormalized predictions. On
CUDA the models run the fused kernels whenever K <= 8. Dense and packed
bundles come with their slices.
"""

from __future__ import annotations

import json
import os
from typing import Any, Sequence

import numpy as np
import torch

from hgnn2_torch import resolve_device
from hgnn2_torch.graphs import GraphRecord
from hgnn2_torch.nn import ccn as ccn_mod
from hgnn2_torch.ops import ccn_fused

_MODEL = "model.pt"
_META = "meta.json"
_ARCHS = {"ccn1d": ccn_mod.CCN1D, "ccn2d": ccn_mod.CCN2D}


def _input_spec(batch_size: int, vertex_capacity: int, k_max: int,
                feature_dim: int) -> dict[str, list]:
    """Every array field of a CCN batch but the labels, as {name: [shape,
    dtype]}: the JAX bundle's input_spec format."""
    V, K, B = vertex_capacity, k_max, batch_size
    return {
        "chi_idx": [[V, K, K], "int32"],
        "deg": [[V], "float32"],
        "gid": [[V], "int32"],
        "gmask": [[B], "float32"],
        "nbr": [[V, K], "int32"],
        "row_mask": [[V, K], "float32"],
        "rslot": [[V, K], "int32"],
        "vmask": [[V], "float32"],
        "x": [[V, feature_dim], "float32"],
    }


def _arch(model: torch.nn.Module) -> str:
    for name, cls in _ARCHS.items():
        if type(model) is cls:
            return name
    raise ValueError(f"no bundle format for {type(model).__name__}")


def save_bundle(
    path: str,
    model: ccn_mod.CCN1D | ccn_mod.CCN2D,
    buckets: Sequence[tuple[int, int]],
    *,
    k_max: int,
    task: int | None = None,
    mean: float = 0.0,
    std: float = 1.0,
    add_self_loops: bool = True,
) -> None:
    """Write a CCN serving bundle. buckets: (graph slots, vertex capacity)
    per serving bucket, all at one receptive-field size k_max. A bucket
    with more slots must not have a smaller vertex capacity (predict packs
    chunks against the largest bucket)."""
    if not buckets:
        raise ValueError("a bundle needs at least one serving bucket")
    by_slots = sorted(buckets)
    for (b0, v0), (b1, v1) in zip(by_slots, by_slots[1:]):
        if v1 < v0:
            raise ValueError(
                f"bucket capacities are not monotone: {b1} slots hold "
                f"{v1} vertices < {v0} for {b0} slots")
    specs = [_input_spec(b, v, k_max, model.n_features) for b, v in buckets]
    meta = {
        "kind": "ccn",
        "arch": _arch(model),
        "task": task,
        "mean": float(mean),
        "std": float(std),
        "input_spec": specs[0],
        "extra_buckets": specs[1:],
        "add_self_loops": bool(add_self_loops),
        "n_features": model.n_features,
        "n_layers": model.n_layers,
        "hidden": model.hidden,
        "dim_output": model.dim_output,
        "compat_contractions": bool(getattr(model, "compat_contractions", False)),
    }
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(path, _MODEL))
    with open(os.path.join(path, _META), "w") as f:
        f.write(json.dumps(meta, indent=1) + "\n")


class ServingModel:
    """A loaded CCN bundle: the model on its device plus request batching."""

    def __init__(self, model: torch.nn.Module, meta: dict[str, Any],
                 device: torch.device):
        self.model = model
        self.meta = meta
        self.device = device
        specs = [meta["input_spec"], *meta.get("extra_buckets", ())]
        # (graph slots, vertex capacity), most slots first
        self.buckets = sorted(
            ((int(s["gmask"][0][0]), int(s["x"][0][0])) for s in specs),
            reverse=True)
        self.k_max = int(meta["input_spec"]["nbr"][0][1])

    @property
    def kind(self) -> str:
        return self.meta["kind"]

    def predict(self, records: Sequence[GraphRecord]) -> np.ndarray:
        """Pack records into the bundle's buckets (vertex capacity V,
        receptive field K, graph slots B) chunk by chunk; returns the
        denormalized prediction of each record."""
        bsz, v_cap = self.buckets[0]
        add_loops = bool(self.meta.get("add_self_loops", True))
        bump = 1 if add_loops else 0
        task = self.meta.get("task")
        mean, std = self.meta["mean"], self.meta["std"]

        for i, r in enumerate(records):
            if r.max_degree() + bump > self.k_max:
                raise ValueError(
                    f"record {i} degree {r.max_degree()}+{bump} exceeds "
                    f"the bundle's K={self.k_max} — re-export with a larger "
                    "k_max"
                )
            if r.n_nodes > v_cap:
                raise ValueError(
                    f"record {i} with {r.n_nodes} vertices exceeds the "
                    f"bundle's vertex capacity {v_cap}"
                )
        if not len(records):
            return np.empty(0, np.float32)
        sizes = np.array([[r.n_nodes] for r in records])
        out = np.empty(len(records), np.float32)
        for lo, hi in _greedy_spans(sizes, (v_cap,), bsz):
            nodes = int(sizes[lo:hi].sum())
            slots, cap = min((b for b in self.buckets
                              if b[0] >= hi - lo and b[1] >= nodes))
            batch = ccn_mod.make_ccn_batch(
                records[lo:hi], k_max=self.k_max, vertex_capacity=cap,
                add_self_loops=add_loops, task=task, batch_size=slots,
                device=self.device,
            )
            with torch.inference_mode():
                pred = self.model(batch)[:, 0].cpu().numpy()
            out[lo:hi] = pred[: hi - lo] * std + mean
        return out


def _greedy_spans(sizes: np.ndarray, caps: Sequence[int], bsz: int):
    """Sequential greedy packing preserving record order, O(n) via running
    totals. sizes: (n, k) per-record resource vectors; caps: (k,)
    capacities; bsz: max records per chunk. Yields (lo, hi) spans. Callers
    validate that every single record fits an empty chunk beforehand."""
    caps = np.asarray(caps)
    lo = 0
    run = np.zeros_like(caps)
    for i in range(len(sizes)):
        if i > lo and (i - lo >= bsz or ((run + sizes[i]) > caps).any()):
            yield lo, i
            lo = i
            run = np.zeros_like(caps)
        run = run + sizes[i]
    if len(sizes) > lo:
        yield lo, len(sizes)


def load_bundle(path: str, device: str | torch.device | None = None) -> ServingModel:
    """Load a bundle onto ``device`` (default cuda). On CUDA the model runs
    the fused kernels when the bundle's K allows (ccn_fused.use_kernel)."""
    dev = resolve_device(device)
    with open(os.path.join(path, _META)) as f:
        meta = json.loads(f.read())
    if meta.get("kind") != "ccn":
        raise ValueError(f"unsupported bundle kind {meta.get('kind')!r}")
    k_max = int(meta["input_spec"]["nbr"][0][1])
    kwargs = dict(n_features=meta["n_features"], hidden=meta["hidden"],
                  n_layers=meta["n_layers"], dim_output=meta["dim_output"],
                  kernel=ccn_fused.use_kernel(k_max, dev))
    if meta["arch"] == "ccn2d":
        kwargs["compat_contractions"] = meta["compat_contractions"]
    model = _ARCHS[meta["arch"]](**kwargs)
    state = torch.load(os.path.join(path, _MODEL), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state)
    return ServingModel(model.to(dev).eval(), meta, dev)
