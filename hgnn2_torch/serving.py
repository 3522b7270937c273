"""Serving bundles for every model of the port (counterpart of
hgnn2_tpu/serving.py): dense (GNNSimple; GNNLineGraph, whose batches
carry line graphs), packed (PackedGNN, PackedLGGNN) and CCN (CCN1D,
CCN2D).

A bundle is a directory:
    model.pt    the model's state_dict (float32 tensors, BN buffers
                included)
    meta.json   kind, arch, task, target mean/std, one input_spec per
                serving bucket (input_spec, then extra_buckets), each
                bucket's static fields, and the hyperparameters that
                rebuild the model

The JAX bundle freezes a StableHLO program per bucket; here a bucket is
its input spec ({name: [shape, dtype]}, the JAX bundle's format, labels
excluded) plus the fields that JAX's make_forward bakes into its program
(static: the zero label placeholder y and, for packed and CCN batches,
n_graphs), and one set of weights serves every bucket, since PyTorch runs
eagerly. ``load_bundle(path).predict(records)`` chunks an arbitrary
number of GraphRecords into the buckets as the JAX package does, runs the
eval forward under ``torch.inference_mode()`` and returns denormalized
predictions; ``call(arrays)`` runs one already-shaped batch, routed by the
shape of x. On CUDA the CCN models run the fused kernels whenever K <= 8.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from hgnn2_torch import graphs, resolve_device
from hgnn2_torch.graphs import GraphRecord
from hgnn2_torch.nn import ccn as ccn_mod
from hgnn2_torch.nn import models, packed
from hgnn2_torch.nn.layers import CompatConfig
from hgnn2_torch.ops import ccn_fused

_MODEL = "model.pt"
_META = "meta.json"
# (kind, arch) of each model class a bundle can hold
_MODELS = {
    ("dense", "gnn"): models.GNNSimple,
    ("dense", "lggnn"): models.GNNLineGraph,
    ("packed", "gnn"): packed.PackedGNN,
    ("packed", "lggnn"): packed.PackedLGGNN,
    ("ccn", "ccn1d"): ccn_mod.CCN1D,
    ("ccn", "ccn2d"): ccn_mod.CCN2D,
}
_BATCHES = {"dense": graphs.DenseGraphBatch, "packed": graphs.PackedGraphBatch,
            "ccn": ccn_mod.CCNBatch}

# Batch fields the eval forward never reads: left out of the input spec
# so a bundle does not demand labels at inference time; the forward gets
# zero placeholders for them.
EXPORT_EXCLUDE = ("y",)


def _dtype_name(dtype) -> str:
    """'float32', 'int32'... for a torch or a numpy dtype."""
    return str(dtype).removeprefix("torch.")


def batch_to_arrays(batch: Any, exclude: Sequence[str] = ()) -> dict[str, Any]:
    """The array fields of any batch (DenseGraphBatch, PackedGraphBatch,
    CCNBatch) as a plain dict, less ``exclude``: the input of
    ServingModel.call. Non-array fields (n_graphs) and unbuilt ones
    (None) are left out."""
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if f.name not in exclude and isinstance(v, (torch.Tensor, np.ndarray)):
            out[f.name] = v
    return out


def input_spec(batch: Any) -> dict:
    """The bucket a batch fixes: {name: [shape, dtype]} of its array
    inputs but the labels, sorted by name (the JAX bundle's input_spec)."""
    arrays = batch_to_arrays(batch, EXPORT_EXCLUDE)
    return {k: [list(v.shape), _dtype_name(v.dtype)]
            for k, v in sorted(arrays.items())}


def _static_fields(batch: Any) -> dict:
    """What JAX's make_forward bakes into a bucket's program: the
    non-array fields' values and, for each label field, the [shape,
    dtype] of its zero placeholder."""
    static = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if v is None:
            continue
        if isinstance(v, (torch.Tensor, np.ndarray)):
            if f.name in EXPORT_EXCLUDE:
                static[f.name] = [list(v.shape), _dtype_name(v.dtype)]
        else:
            static[f.name] = v
    return static


def _ccn_input_spec(batch_size: int, vertex_capacity: int, k_max: int,
                    feature_dim: int) -> dict[str, list]:
    """The input spec of a CCN bucket of (graph slots, vertex capacity) at
    receptive field k_max."""
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


def _slots(spec: Mapping[str, Any]) -> int:
    """Graph slots of a bucket: gmask's length (packed and CCN layouts),
    else x's leading dim (dense)."""
    if "gmask" in spec:
        return int(spec["gmask"][0][0])
    return int(spec["x"][0][0])


def _kind_arch(model: torch.nn.Module) -> tuple[str, str]:
    for key, cls in _MODELS.items():
        if type(model) is cls:
            return key
    raise ValueError(f"no bundle format for {type(model).__name__}")


def _model_meta(model: torch.nn.Module, kind: str) -> dict[str, Any]:
    """The hyperparameters that rebuild ``model`` in load_bundle."""
    if kind == "ccn":
        return {"n_features": model.n_features, "n_layers": model.n_layers,
                "hidden": model.hidden, "dim_output": model.dim_output,
                "compat_contractions": bool(
                    getattr(model, "compat_contractions", False)),
                "vertex_chunks": int(getattr(model, "vertex_chunks", 1))}
    if getattr(model, "dtype", None) is not None:
        raise ValueError("a bundle holds a float32 model; got dtype "
                         f"{model.dtype}")
    if model.compat not in (CompatConfig(), CompatConfig.reference()):
        raise ValueError(f"a bundle records compat as the default or the "
                         f"reference flags; got {model.compat}")
    return {"in_features": model.in_features, "n_features": model.n_features,
            "n_layers": model.n_layers, "J": model.J,
            "order": getattr(model, "order", 1),
            "gru": bool(getattr(model, "gru", False)),
            "compat_reference": model.compat == CompatConfig.reference(),
            "dim_output": model.dim_output}


def _check_buckets(specs: Sequence[dict]) -> None:
    """Several buckets share one input signature, and each input differs
    only in its leading (batch or capacity) dim, so that records validate
    once for every bucket (the JAX package's check)."""
    base = specs[0]
    for s in specs[1:]:
        if set(s) != set(base):
            raise ValueError(
                "multi-bucket bundle: all buckets must share one input "
                f"signature; got {sorted(base)} vs {sorted(s)}")
        for k in base:
            if s[k][0][1:] != base[k][0][1:] or s[k][1] != base[k][1]:
                raise ValueError(
                    f"multi-bucket bundle: input {k!r} differs beyond its "
                    f"leading capacity dim: {base[k]} vs {s[k]}")


def save_bundle(
    path: str,
    model: torch.nn.Module,
    buckets: Sequence[Any],
    *,
    k_max: int | None = None,
    task: int | None = None,
    mean: float = 0.0,
    std: float = 1.0,
    add_self_loops: bool = True,
    extra: Mapping[str, Any] | None = None,
) -> None:
    """Write a serving bundle of ``model``.

    buckets: one entry per serving bucket, each an example batch of the
    model's layout (its shapes fix the bucket; its values are not kept)
    or, for a CCN model, a (graph slots, vertex capacity) pair at
    receptive field k_max. The first is the primary bucket. All buckets
    share one input signature and differ only in each input's leading
    dim. A CCN bucket with more slots must not have a smaller vertex
    capacity (predict packs chunks against the bucket of most slots).
    add_self_loops: CCN only, how predict builds the chi tables (A + I,
    as CCNLoader does, by default). extra: more meta entries (the
    exporting CLI's arch and checkpoint epoch)."""
    kind, arch = _kind_arch(model)
    if not buckets:
        raise ValueError("a bundle needs at least one serving bucket")
    specs, statics = [], []
    for b in buckets:
        if isinstance(b, tuple):
            if kind != "ccn" or k_max is None:
                raise ValueError("(graph slots, vertex capacity) buckets are "
                                 "for CCN models, with k_max")
            slots, cap = b
            specs.append(_ccn_input_spec(slots, cap, k_max, model.n_features))
            statics.append({"y": [[slots], "float32"], "n_graphs": slots})
        elif isinstance(b, _BATCHES[kind]):
            specs.append(input_spec(b))
            statics.append(_static_fields(b))
        else:
            raise TypeError(f"a {kind} bundle's bucket is a "
                            f"{_BATCHES[kind].__name__}; got {type(b).__name__}")
    _check_buckets(specs)
    if kind == "ccn":
        by_slots = sorted((_slots(s), int(s["x"][0][0])) for s in specs)
        for (b0, v0), (b1, v1) in zip(by_slots, by_slots[1:]):
            if v1 < v0:
                raise ValueError(
                    f"bucket capacities are not monotone: {b1} slots hold "
                    f"{v1} vertices < {v0} for {b0} slots")
    meta = {
        "kind": kind,
        "arch": arch,
        "task": task,
        "mean": float(mean),
        "std": float(std),
        "input_spec": specs[0],
        "extra_buckets": specs[1:],
        "static": statics,
        **_model_meta(model, kind),
    }
    if kind == "ccn":
        meta["add_self_loops"] = bool(add_self_loops)
    meta.update(extra or {})
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(path, _MODEL))
    with open(os.path.join(path, _META), "w") as f:
        f.write(json.dumps(meta, indent=1) + "\n")


class ServingModel:
    """A loaded bundle: the model on its device plus request batching.

    ``call(arrays)`` runs the eval forward on one already-shaped batch.
    ``predict(records)`` serves any number of GraphRecords: chunks them
    into the buckets, pads each chunk, and returns denormalized per-graph
    predictions. ``_programs`` holds (input spec, forward) per bucket,
    most graph slots first, as the JAX ServingModel's does."""

    def __init__(self, model: torch.nn.Module, meta: dict[str, Any],
                 device: torch.device):
        self.model = model
        self.meta = meta
        self.device = device
        specs = [meta["input_spec"], *meta.get("extra_buckets", ())]
        programs = [(s, self._program(st))
                    for s, st in zip(specs, meta["static"])]
        # a stable sort, as JAX's: equal slot counts keep the save order
        self._programs = sorted(programs, key=lambda p: -_slots(p[0]))

    def _program(self, static: Mapping[str, Any]) -> Callable:
        """The eval forward of one bucket over a dict of its inputs, with
        the bucket's static fields filled in."""
        batch_cls = _BATCHES[self.kind]

        def forward(arrays: Mapping[str, Any]) -> torch.Tensor:
            fields = {k: torch.as_tensor(v, device=self.device)
                      for k, v in arrays.items()}
            for name, value in static.items():
                if isinstance(value, list):  # a zero placeholder's spec
                    shape, dtype = value
                    value = torch.zeros(shape, dtype=getattr(torch, dtype),
                                        device=self.device)
                fields[name] = value
            with torch.inference_mode():
                return self.model(batch_cls(**fields))

        return forward

    @property
    def kind(self) -> str:
        return self.meta["kind"]

    @property
    def input_spec(self) -> dict[str, Any]:
        return self.meta["input_spec"]

    @property
    def buckets(self) -> list[tuple[int, int]]:
        """(graph slots, leading dim of x) of each bucket, most slots
        first; x's leading dim is the vertex capacity of packed and CCN
        buckets."""
        return [(_slots(s), int(s["x"][0][0])) for s, _ in self._programs]

    @property
    def k_max(self) -> int | None:
        """The receptive field K of a CCN bundle (None for the others)."""
        if self.kind != "ccn":
            return None
        return int(self.input_spec["nbr"][0][1])

    def call(self, arrays: Mapping[str, Any]) -> torch.Tensor:
        """The eval forward over one batch's arrays (tensors or numpy
        arrays, e.g. batch_to_arrays(batch)), which must match one
        bucket's input spec. Inputs outside the spec (labels) are dropped;
        a bundle of several buckets routes by the shape of x. Returns the
        raw (normalized) outputs on the bundle's device."""
        arrays = {k: v for k, v in arrays.items() if k in self.input_spec}
        missing = sorted(set(self.input_spec) - set(arrays))
        if missing:
            raise ValueError(f"inputs {missing} missing for this bundle")
        x_shape = list(arrays["x"].shape)
        for spec, program in self._programs:
            if spec["x"][0] == x_shape:
                break
        else:
            raise ValueError(
                f"x of shape {x_shape} fits no serving bucket of this bundle "
                f"({[s['x'][0] for s, _ in self._programs]})")
        for k, (shape, dtype) in spec.items():
            v = arrays[k]
            if list(v.shape) != shape or _dtype_name(v.dtype) != dtype:
                raise ValueError(
                    f"input {k!r} is {_dtype_name(v.dtype)} {list(v.shape)}; "
                    f"the bucket takes {dtype} {shape}")
        return program(arrays)

    def build_batch(self, records: Sequence[GraphRecord],
                    spec: Mapping[str, Any]):
        """The batch of ``records`` at a bucket's shapes, on the bundle's
        device, as predict builds it."""
        task = self.meta.get("task")
        B = _slots(spec)
        if self.kind == "dense":
            with_lg = "lg_src" in spec
            return graphs.make_dense_batch(
                records, n_max=int(spec["x"][0][1]),
                m_max=int(spec["lg_src"][0][1]) if with_lg else None,
                batch_size=B, with_line_graph=with_lg, task=task,
                device=self.device)
        if self.kind == "packed":
            return graphs.make_packed_batch(
                records, node_capacity=int(spec["x"][0][0]),
                edge_capacity=int(spec["src"][0][0]), task=task,
                batch_size=B, device=self.device)
        return ccn_mod.make_ccn_batch(
            records, k_max=int(spec["nbr"][0][1]),
            vertex_capacity=int(spec["x"][0][0]),
            add_self_loops=bool(self.meta.get("add_self_loops", True)),
            task=task, batch_size=B, device=self.device)

    def _run(self, records, spec, program) -> np.ndarray:
        """Denormalized predictions of one chunk through one bucket."""
        batch = self.build_batch(records, spec)
        arrays = {k: v for k, v in batch_to_arrays(batch).items() if k in spec}
        pred = program(arrays)[:, 0].float().cpu().numpy()
        return pred[: len(records)] * self.meta["std"] + self.meta["mean"]

    def predict(self, records: Sequence[GraphRecord]) -> np.ndarray:
        """Serve any number of GraphRecords through the bundle's buckets;
        returns each record's denormalized prediction."""
        if self.kind == "ccn":
            return self._predict_ccn(records)
        if self.kind == "packed":
            return self._predict_packed(records)
        return self._predict_dense(records)

    def _predict_dense(self, records: Sequence[GraphRecord]) -> np.ndarray:
        n_max = int(self.input_spec["x"][0][1])
        with_lg = "lg_src" in self.input_spec
        m_max = int(self.input_spec["lg_src"][0][1]) if with_lg else None
        for i, r in enumerate(records):
            if r.n_nodes > n_max or (with_lg and r.n_dir_edges > m_max):
                raise ValueError(
                    f"record {i} ({r.n_nodes} nodes"
                    + (f", {r.n_dir_edges} directed edges" if with_lg else "")
                    + f") exceeds this bundle's serving bucket "
                    f"(n_max={n_max}" + (f", m_max={m_max}" if with_lg else "")
                    + ") — re-export with a larger example batch"
                )
        out = np.empty(len(records), np.float32)
        lo = 0
        while lo < len(records):
            # one padded call of the smallest bucket that holds the rest of
            # the request; the largest bucket in a loop while none does
            remaining = len(records) - lo
            covering = [p for p in self._programs if _slots(p[0]) >= remaining]
            spec, program = covering[-1] if covering else self._programs[0]
            chunk = records[lo : lo + _slots(spec)]
            out[lo : lo + len(chunk)] = self._run(chunk, spec, program)
            lo += len(chunk)
        return out

    def _predict_ccn(self, records: Sequence[GraphRecord]) -> np.ndarray:
        """Pack records into the CCN buckets (vertex capacity V, receptive
        field K, graph slots B) chunk by chunk."""
        bsz, v_cap = self.buckets[0]
        bump = 1 if self.meta.get("add_self_loops", True) else 0
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
            spec, program = min(
                (p for p in self._programs
                 if _slots(p[0]) >= hi - lo and int(p[0]["x"][0][0]) >= nodes),
                key=lambda p: _slots(p[0]))
            out[lo:hi] = self._run(records[lo:hi], spec, program)
        return out

    def _predict_packed(self, records: Sequence[GraphRecord]) -> np.ndarray:
        """Pack records against the largest bucket (node capacity V, edge
        capacity C, graph slots B), then route each chunk to the smallest
        bucket that holds it."""
        big = self._programs[0][0]
        v_cap, e_cap = int(big["x"][0][0]), int(big["src"][0][0])
        if not len(records):
            return np.empty(0, np.float32)
        sizes = np.array([[r.n_nodes, r.n_dir_edges] for r in records])
        too_big = (sizes[:, 0] > v_cap) | (sizes[:, 1] > e_cap)
        if too_big.any():
            i = int(np.argmax(too_big))
            raise ValueError(
                f"record {i} ({sizes[i, 0]} nodes, {sizes[i, 1]} directed "
                f"edges) exceeds the bundle's packed capacities "
                f"(V={v_cap}, C={e_cap}) — re-export with larger ones"
            )
        out = np.empty(len(records), np.float32)
        for lo, hi in _greedy_spans(sizes, (v_cap, e_cap), _slots(big)):
            nodes, edges = sizes[lo:hi].sum(axis=0)
            spec, program = min(
                (p for p in self._programs
                 if _slots(p[0]) >= hi - lo
                 and int(p[0]["x"][0][0]) >= nodes
                 and int(p[0]["src"][0][0]) >= edges),
                key=lambda p: _slots(p[0]))
            out[lo:hi] = self._run(records[lo:hi], spec, program)
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


def _build_model(meta: Mapping[str, Any], dev: torch.device) -> torch.nn.Module:
    """The bundle's model, with freshly drawn weights, from its meta."""
    kind, arch = meta.get("kind"), meta.get("arch")
    cls = _MODELS.get((kind, arch))
    if cls is None:
        raise ValueError(f"unsupported bundle kind {kind!r} with arch {arch!r}")
    if kind == "ccn":
        kw = dict(n_features=meta["n_features"], hidden=meta["hidden"],
                  n_layers=meta["n_layers"], dim_output=meta["dim_output"],
                  kernel=ccn_fused.use_kernel(
                      int(meta["input_spec"]["nbr"][0][1]), dev))
        if arch == "ccn2d":
            kw["compat_contractions"] = meta["compat_contractions"]
            # bundles written before CCN2D had vertex chunks hold none
            kw["vertex_chunks"] = meta.get("vertex_chunks", 1)
        return cls(**kw)
    kw = dict(in_features=meta["in_features"], n_features=meta["n_features"],
              n_layers=meta["n_layers"], dim_output=meta["dim_output"],
              J=meta["J"],
              compat=(CompatConfig.reference() if meta["compat_reference"]
                      else CompatConfig()))
    if arch == "lggnn":
        kw["order"] = meta["order"]
    if cls is models.GNNSimple:
        kw["gru"] = meta["gru"]
    # bundles written while GNNLineGraph had a fused_ops option carry it in
    # their meta; it chose another form of the same math, and is ignored
    return cls(**kw)


def load_bundle(path: str, device: str | torch.device | None = None) -> ServingModel:
    """Load a bundle onto ``device`` (default cuda). On CUDA a CCN model
    runs the fused kernels when the bundle's K allows
    (ccn_fused.use_kernel)."""
    dev = resolve_device(device)
    with open(os.path.join(path, _META)) as f:
        meta = json.loads(f.read())
    model = _build_model(meta, dev)
    state = torch.load(os.path.join(path, _MODEL), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state)
    return ServingModel(model.to(dev).eval(), meta, dev)
