"""Carry weights from the JAX package's flax param trees into the port's
modules. Inputs are nested dicts of numpy arrays, so no JAX is needed."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def ccn_params_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A CCN1D/CCN2D flax param tree -> the port model's state_dict.

    ``params`` holds one entry per Dense (w1..wL and fc), each with
    ``kernel`` (in, out) and ``bias`` (out,); a full variables dict with a
    top-level "params" key is accepted too. A flax Dense kernel is the
    transpose of a torch Linear weight.
    """
    if "params" in params:
        params = params["params"]
    state = {}
    for name, dense in params.items():
        kernel = np.asarray(dense["kernel"], dtype=np.float32)
        state[f"{name}.weight"] = torch.from_numpy(kernel.T.copy())
        state[f"{name}.bias"] = torch.from_numpy(
            np.asarray(dense["bias"], dtype=np.float32).copy())
    return state


def ccn_params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, dict]:
    """The inverse of ccn_params_from_flax: a CCN1D/CCN2D state_dict ->
    {name: {"kernel": (in, out), "bias": (out,)}} of float32 numpy arrays,
    the layout of the JAX models' params."""
    params: dict[str, dict] = {}
    for key, t in state_dict.items():
        name, field = key.rsplit(".", 1)
        arr = t.detach().cpu().numpy().astype(np.float32)
        if field == "weight":
            params.setdefault(name, {})["kernel"] = arr.T.copy()
        elif field == "bias":
            params.setdefault(name, {})["bias"] = arr.copy()
        else:
            raise ValueError(f"unexpected state_dict entry {key!r}")
    return params


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    """(dotted module path, field, leaf) for each leaf of a nested tree."""
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _flatten(sub, f"{prefix}{name}.")
        else:
            yield prefix[:-1], name, sub


def variables_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax variables of a model with batch norm (PackedLGGNN, PackedGNN,
    GNNSimple) -> the port model's state_dict.

    ``variables`` holds "params" (each Dense's ``kernel`` (in, out) and
    ``bias``; each MaskedBatchNorm's ``scale`` and ``bias``, 0-d under
    scalar_affine_bn) and "batch_stats" (each BN's running ``mean`` and
    ``std``), flat (the packed models) or nested by module (GNNSimple's
    ``layer0/gru/ih``). Module paths are the same in both packages, with
    "." between levels."""
    state = {}
    for tree in ("params", "batch_stats"):
        for path, field, arr in _flatten(variables.get(tree, {})):
            arr = np.asarray(arr, dtype=np.float32)
            if field == "kernel":
                field, arr = "weight", arr.T
            state[f"{path}.{field}"] = torch.from_numpy(arr.copy())
    return state


def variables_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, dict]:
    """The inverse of variables_from_flax: {"params": ..., "batch_stats":
    ...} of float32 numpy arrays in the flax layout, nested by module."""
    out: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *path, field = key.split(".")
        arr = t.detach().cpu().numpy().astype(np.float32)
        if field == "weight":
            field, arr = "kernel", arr.T
        elif field not in ("bias", "scale", "mean", "std"):
            raise ValueError(f"unexpected state_dict entry {key!r}")
        node = out["batch_stats" if field in ("mean", "std") else "params"]
        for name in path:
            node = node.setdefault(name, {})
        node[field] = arr.copy()
    return out


# the packed and dense models share the layout rules
packed_variables_from_flax = dense_variables_from_flax = variables_from_flax
packed_variables_to_flax = dense_variables_to_flax = variables_to_flax
