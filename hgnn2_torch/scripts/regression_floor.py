"""Quality floor of the synthetic QM9-shaped regression (counterpart of
scripts/regression_floor.py).

    python -m hgnn2_torch.scripts.regression_floor [--n 2000] [--seed 0]
        [--task 0] [--out runs/validation_reg_floor_torch]

The synthetic targets are a fixed linear mix of five exact structural
features plus N(0, 0.01) noise (data/qm9.py:synthetic_qm9_like). A least-
squares fit on those features recovers the mix up to the noise, which
gives the error ratio no model can beat without predicting the noise.
Writes OUT/floor.json with, per split, the fit's raw MAE, normalized MAE
and error ratio (MAE / std / chemical accuracy, the metric of the
validation runs), for the exact features and for the features a model
that cannot see bond orders has (the CCN models' chi tables use the
unweighted adjacency). Pure numpy over the port's data modules: the
records are the JAX package's, so the file equals JAX's
runs/validation_reg_floor{,_8000}/floor.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from hgnn2_torch.data import qm9, stats, synthetic

DEFAULT_OUT = os.path.join("runs", "validation_reg_floor_torch")


def structural_features(r):
    """The exact generator features (data/qm9.py:synthetic_qm9_like)."""
    adj, x = r.adj, r.x
    return [
        x.shape[0],                 # n_atoms
        adj.sum() / 2.0,            # total bond order
        (adj == 2.0).sum() / 2.0,   # double bonds
        x[:, 1].sum(),              # atom-type count (one-hot col 1)
        x[:, 0].sum(),              # atom-type count (one-hot col 0)
    ]


def order_blind_features(r):
    """The best features without bond orders, which the CCN models cannot
    see (their neighbourhoods come from the unweighted adjacency). Total
    bond order and the double-bond count are missing, so this fit is the
    CCN floor."""
    adj, x = r.adj, r.x
    return [x.shape[0], (adj > 0).sum() / 2.0] + [
        x[:, c].sum() for c in range(x.shape[1])
    ]


def floor(n: int, seed: int = 0, task: int = 0) -> dict:
    """floor.json's content for n molecules of synthetic_qm9_like(seed)."""
    recs = qm9.synthetic_qm9_like(n, seed=seed)
    ts = stats.compute_target_stats(recs)
    tr, va, te = synthetic.split_80_10_10(recs)
    std = float(ts.std[task])
    acc = float(ts.accuracy[task])

    def fit_eval(featfn):
        def design(split):
            F = np.array([featfn(r) for r in split])
            return np.concatenate([F, np.ones((len(F), 1))], axis=1)

        y_tr = np.array([r.y[task] for r in tr])
        coef, *_ = np.linalg.lstsq(design(tr), y_tr, rcond=None)
        res = {}
        for name, split in (("train", tr), ("valid", va), ("test", te)):
            y = np.array([r.y[task] for r in split])
            raw = float(np.abs(design(split) @ coef - y).mean())
            res[name] = {
                "raw_mae": raw,
                "normalized_mae": raw / std,
                "error_ratio": raw / std / acc,
            }
        return res

    return {
        "n_molecules": n,
        "seed": seed,
        "task": task,
        "target_std": std,
        "chemical_accuracy": acc,
        "noise_sigma": 0.01,
        "noise_only_expected_raw_mae": 0.01 * float(np.sqrt(2.0 / np.pi)),
        "oracle": "least squares on the exact generator features "
                  "[n_atoms, total_bond_order, n_double_bonds, "
                  "type_count_1, type_count_0] + bias",
        "splits": fit_eval(structural_features),
        # the CCN visibility class: no bond orders (chi from unweighted A)
        "order_blind_oracle_splits": fit_eval(order_blind_features),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--task", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    out = floor(args.n, args.seed, args.task)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "floor.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out["splits"]))
    print(f"wrote {path}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
