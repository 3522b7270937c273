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
